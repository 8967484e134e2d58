"""Stackless flattened-BVH traversal over ray wavefronts.

Replaces the reference's recursive pointer k-d tree descent
(Tree.cs:67-128) with a skip-link walk: one int32 cursor per ray, advanced
`idx+1` on AABB hit and `skip[idx]` on miss, leaves intersecting a
fixed-width contiguous triangle block. The whole ray batch advances in
lockstep inside a single `lax.while_loop` with masked updates (no per-ray
call stack, static shapes, batched gathers). `pallas/traverse_gpu.py` runs
the K-wide walk as one per-lane GPU kernel over the same tables.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ptsharp.core import vec
from ptsharp.geometry import primitives


class MeshArrays(NamedTuple):
    """Device-side flattened BVH + sorted triangle soup for one or more
    meshes concatenated; traversal operates on a node slice [base, base+n)
    and triangle indices are global."""

    node_bmin: jnp.ndarray  # (N, 3)
    node_bmax: jnp.ndarray  # (N, 3)
    node_first: jnp.ndarray  # (N,) leaf -> first sorted-triangle index
    node_count: jnp.ndarray  # (N,) 0 = internal
    node_skip: jnp.ndarray  # (N,)
    v0: jnp.ndarray  # (T + pad, 3) BVH-sorted vertices
    e1: jnp.ndarray  # (T + pad, 3) v1 - v0 (precomputed M-T edges)
    e2: jnp.ndarray  # (T + pad, 3) v2 - v0
    max_leaf: int


def traverse(
    mesh: MeshArrays,
    org,
    dirn,
    t_max,
    node_base,
    node_end,
    max_iters: int = 8192,
):
    """Closest-hit traversal for a ray batch against nodes
    [node_base, node_end). org/dirn (R, 3) may be unnormalized (instance
    space); t is parametric in the given direction scale.

    Returns (t, tri_idx, u, v): t = INF and tri_idx = -1 on miss; tri_idx
    indexes the *sorted* triangle arrays.
    """
    # while_loop is not reverse-differentiable: detach ray geometry here.
    # Gradients flow through shading (material/emitter params), not through
    # the discrete traversal — the detached-sampling estimator SURVEY.md §7
    # calls for.
    org = jax.lax.stop_gradient(org)
    dirn = jax.lax.stop_gradient(dirn)
    t_max = jax.lax.stop_gradient(t_max)
    r = org.shape[0]
    leaf = mesh.max_leaf
    inv_d = 1.0 / jnp.where(jnp.abs(dirn) < 1e-30, jnp.where(dirn < 0, -1e-30, 1e-30), dirn)

    def cond(state):
        idx, best_t, best_tri, best_u, best_v, it = state
        return jnp.logical_and(jnp.any(idx < node_end), it < max_iters)

    def body(state):
        idx, best_t, best_tri, best_u, best_v, it = state
        active = idx < node_end
        safe_idx = jnp.where(active, idx, node_base)
        nb_min = mesh.node_bmin[safe_idx]
        nb_max = mesh.node_bmax[safe_idx]
        n_first = mesh.node_first[safe_idx]
        n_count = mesh.node_count[safe_idx]
        n_skip = mesh.node_skip[safe_idx]

        lo = (nb_min - org) * inv_d
        hi = (nb_max - org) * inv_d
        tmin = jnp.max(jnp.minimum(lo, hi), axis=-1)
        tmax = jnp.min(jnp.maximum(lo, hi), axis=-1)
        box_hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < best_t)

        is_leaf = n_count > 0
        do_leaf = active & box_hit & is_leaf

        # --- leaf block intersection (fixed-width, masked) ---------------
        start = jnp.where(do_leaf, n_first, 0)
        tv0 = _gather_block(mesh.v0, start, leaf)  # (R, leaf, 3)
        te1 = _gather_block(mesh.e1, start, leaf)
        te2 = _gather_block(mesh.e2, start, leaf)
        d = dirn[:, None, :]
        o = org[:, None, :]
        h = jnp.cross(d, te2)
        det = jnp.sum(te1 * h, axis=-1)
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        s = o - tv0
        u = jnp.sum(s * h, axis=-1) * inv_det
        q = jnp.cross(s, te1)
        v = jnp.sum(d * q, axis=-1) * inv_det
        t = jnp.sum(te2 * q, axis=-1) * inv_det
        lane = jax.lax.broadcasted_iota(jnp.int32, (r, leaf), 1)
        ok = (
            do_leaf[:, None]
            & (lane < n_count[:, None])
            & (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > primitives.EPS_T)
            & (t < best_t[:, None])
        )
        t_ok = jnp.where(ok, t, vec.INF)
        lane_best = jnp.argmin(t_ok, axis=-1)
        # min/masked-sum instead of take_along_axis: fused reductions, no
        # second gather
        t_lane = jnp.min(t_ok, axis=-1)
        sel = lane == lane_best[:, None]
        u_lane = jnp.sum(jnp.where(sel, u, 0.0), axis=-1)
        v_lane = jnp.sum(jnp.where(sel, v, 0.0), axis=-1)
        got = t_lane < best_t
        best_t = jnp.where(got, t_lane, best_t)
        best_tri = jnp.where(got, start + lane_best, best_tri)
        best_u = jnp.where(got, u_lane, best_u)
        best_v = jnp.where(got, v_lane, best_v)

        # --- advance cursor ----------------------------------------------
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, idx + 1, n_skip)
        idx = jnp.where(active, nxt, idx)
        return idx, best_t, best_tri, best_u, best_v, it + 1

    init = (
        jnp.full((r,), 0, jnp.int32) + node_base,
        jnp.full((r,), t_max, jnp.float32)
        if jnp.ndim(t_max) == 0
        else t_max.astype(jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.int32(0),
    )
    idx, best_t, best_tri, best_u, best_v, _ = jax.lax.while_loop(cond, body, init)
    best_t = jnp.where(best_tri >= 0, best_t, vec.INF)
    return best_t, best_tri, best_u, best_v


def unpack_bits(rows):
    """Unpack the packed node row metadata: (first, skip, kind, count).
    Layout (scene.py packer): slot 6 = first, slot 7 = kind<<8|count,
    slot 8 = skip — skip owns a full int32 so node counts are uncapped
    (the reference renders the 871k-tri dragon, Example.cs:977)."""
    first = jax.lax.bitcast_convert_type(rows[..., 6], jnp.int32)
    meta = jax.lax.bitcast_convert_type(rows[..., 7], jnp.int32)
    skip = jax.lax.bitcast_convert_type(rows[..., 8], jnp.int32)
    kind = jax.lax.shift_right_logical(meta, 8) & 0xF
    count = meta & 0xFF
    return first, skip, kind, count


def leaf_intersect(leaf_rows, blk_id, o, d, best_t, leaf_size: int,
                   active):
    """Fixed-width leaf block Möller–Trumbore from ONE packed row per ray.

    leaf_rows (NL, leaf*9); blk_id (R,) leaf-row index (garbage rows are
    fetched but masked by `active`). Returns (t, slot_lane, u, v) per ray —
    t = INF when no triangle in the block beats best_t.
    """
    r = o.shape[0]
    blk = leaf_rows[jnp.clip(blk_id, 0, leaf_rows.shape[0] - 1)]
    blk = blk.reshape(r, leaf_size, 9)
    tv0 = blk[:, :, 0:3]
    te1 = blk[:, :, 3:6]
    te2 = blk[:, :, 6:9]
    d3 = d[:, None, :]
    o3 = o[:, None, :]
    h = jnp.cross(d3, te2)
    det = jnp.sum(te1 * h, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    sv = o3 - tv0
    u = jnp.sum(sv * h, axis=-1) * inv_det
    q = jnp.cross(sv, te1)
    v = jnp.sum(d3 * q, axis=-1) * inv_det
    t = jnp.sum(te2 * q, axis=-1) * inv_det
    ok = (
        active[:, None]
        & (jnp.abs(det) > 1e-12)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > primitives.EPS_T)
        & (t < best_t[:, None])
    )
    # pad slots are all-zero -> det == 0 -> rejected; no count mask needed
    t_ok = jnp.where(ok, t, vec.INF)
    lane = jax.lax.broadcasted_iota(jnp.int32, (r, leaf_size), 1)
    lane_best = jnp.argmin(t_ok, axis=-1)
    t_lane = jnp.min(t_ok, axis=-1)
    sel = lane == lane_best[:, None]
    u_lane = jnp.sum(jnp.where(sel, u, 0.0), axis=-1)
    v_lane = jnp.sum(jnp.where(sel, v, 0.0), axis=-1)
    return t_lane, lane_best, u_lane, v_lane


def traverse_packed(rows, leaf_rows, org, dirn, t_max, base, end,
                    leaf_size: int, max_iters: int = 65536):
    """Skip-link walk over packed node rows: per step ONE (8,) node-row
    gather + (on leaf) ONE (leaf*9,) leaf-row gather.

    Returns (t, slot, u, v); slot indexes the slot-ordered triangle arrays,
    -1 on miss.
    """
    org = jax.lax.stop_gradient(org)
    dirn = jax.lax.stop_gradient(dirn)
    t_max = jax.lax.stop_gradient(t_max)
    r = org.shape[0]
    inv_d = 1.0 / jnp.where(
        jnp.abs(dirn) < 1e-30, jnp.where(dirn < 0, -1e-30, 1e-30), dirn
    )

    def cond(state):
        idx, _bt, _bs, _bu, _bv, it = state
        return jnp.logical_and(jnp.any(idx < end), it < max_iters)

    def body(state):
        idx, bt, bs, bu, bv, it = state
        active = idx < end
        safe = jnp.where(active, idx, base)
        nrow = rows[safe]  # (R, 8) — the only node gather
        first, skip, _kind, cnt = unpack_bits(nrow)
        lo = (nrow[:, 0:3] - org) * inv_d
        hi = (nrow[:, 3:6] - org) * inv_d
        tmin = jnp.max(jnp.minimum(lo, hi), axis=-1)
        tmax = jnp.min(jnp.maximum(lo, hi), axis=-1)
        box_hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < bt)

        is_leaf = cnt > 0
        do_leaf = active & box_hit & is_leaf
        blk_id = first // leaf_size
        t_lane, lane_best, u_lane, v_lane = leaf_intersect(
            leaf_rows, jnp.where(do_leaf, blk_id, 0), org, dirn, bt,
            leaf_size, do_leaf,
        )
        got = t_lane < bt
        bt = jnp.where(got, t_lane, bt)
        bs = jnp.where(got, first + lane_best, bs)
        bu = jnp.where(got, u_lane, bu)
        bv = jnp.where(got, v_lane, bv)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, idx + 1, skip)
        idx = jnp.where(active, nxt, idx)
        return idx, bt, bs, bu, bv, it + 1

    init = (
        jnp.full((r,), base, jnp.int32),
        jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)).astype(jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.int32(0),
    )
    idx, bt, bs, bu, bv, _ = jax.lax.while_loop(cond, body, init)
    bt = jnp.where(bs >= 0, bt, vec.INF)
    return bt, bs, bu, bv


def unpack_wide_bits(rows, k: int):
    """Unpack wide-row metadata (accel/wide.py pack_rows layout):
    (first, kind, count, skip, child_idx (..., K))."""
    first = jax.lax.bitcast_convert_type(rows[..., 6], jnp.int32)
    meta = jax.lax.bitcast_convert_type(rows[..., 7], jnp.int32)
    skip = jax.lax.bitcast_convert_type(rows[..., 8], jnp.int32)
    kind = jax.lax.shift_right_logical(meta, 8) & 0xF
    count = meta & 0xFF
    cidx = jax.lax.bitcast_convert_type(rows[..., 9 + 6 * k:9 + 7 * k],
                                        jnp.int32)
    return first, kind, count, skip, cidx


def wide_child_step(nrow, k, org, inv_d, bt, cidx, skip):
    """Shared K-way descent arithmetic: slab-test the K child boxes held in
    an arrived node's row and return (target, has_child) — the preorder
    index of the FIRST hit child (min index = preorder order, so the skip
    chain provably reaches every later hit child) or `skip` when none hit.
    Absent children carry a far-sentinel box AND index 0 (< any real child
    index), so they can never be selected."""
    r = org.shape[0]
    cb = nrow[:, 9:9 + 6 * k].reshape(r, k, 6)
    clo = (cb[:, :, 0:3] - org[:, None, :]) * inv_d[:, None, :]
    chi = (cb[:, :, 3:6] - org[:, None, :]) * inv_d[:, None, :]
    ctmin = jnp.max(jnp.minimum(clo, chi), axis=-1)
    ctmax = jnp.min(jnp.maximum(clo, chi), axis=-1)
    chit = (
        (ctmax >= jnp.maximum(ctmin, 0.0))
        & (ctmin < bt[:, None])
        & (cidx > 0)
    )
    big = jnp.int32(2**31 - 1)
    target = jnp.min(jnp.where(chit, cidx, big), axis=-1)
    has_child = target < big
    return jnp.where(has_child, target, skip), has_child


def traverse_wide(rows, leaf_rows, org, dirn, t_max, base, end,
                  leaf_size: int, k: int, max_iters: int = 65536):
    """K-wide skip walk (accel/wide.py): per step ONE wide-row gather.
    The row carries the node's own box, leaf payload, skip link, and its K
    children's boxes + preorder indices; internal steps jump straight to
    the first hit child, so rows of missed children are never gathered —
    the gather count drops to arrivals ~= hit children only, over ~logK
    levels.

    Returns (t, slot, u, v); slot indexes the slot-ordered triangle
    arrays, -1 on miss. Replaces the reference k-d descent
    (Tree.cs:67-128) like traverse_packed, with fewer row gathers.
    """
    org = jax.lax.stop_gradient(org)
    dirn = jax.lax.stop_gradient(dirn)
    t_max = jax.lax.stop_gradient(t_max)
    r = org.shape[0]
    inv_d = 1.0 / jnp.where(
        jnp.abs(dirn) < 1e-30, jnp.where(dirn < 0, -1e-30, 1e-30), dirn
    )

    def cond(state):
        idx, _bt, _bs, _bu, _bv, it = state
        return jnp.logical_and(jnp.any(idx < end), it < max_iters)

    def body(state):
        idx, bt, bs, bu, bv, it = state
        active = idx < end
        safe = jnp.where(active, idx, base)
        nrow = rows[safe]  # (R, W) — the only gather this step
        first, _kind, cnt, skip, cidx = unpack_wide_bits(nrow, k)
        lo = (nrow[:, 0:3] - org) * inv_d
        hi = (nrow[:, 3:6] - org) * inv_d
        tmin = jnp.max(jnp.minimum(lo, hi), axis=-1)
        tmax = jnp.min(jnp.maximum(lo, hi), axis=-1)
        box_hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < bt)

        is_leaf = cnt > 0
        do_leaf = active & box_hit & is_leaf
        t_lane, lane_best, u_lane, v_lane = leaf_intersect(
            leaf_rows, jnp.where(do_leaf, first // leaf_size, 0), org, dirn,
            bt, leaf_size, do_leaf,
        )
        got = t_lane < bt
        bt = jnp.where(got, t_lane, bt)
        bs = jnp.where(got, first + lane_best, bs)
        bu = jnp.where(got, u_lane, bu)
        bv = jnp.where(got, v_lane, bv)

        target, _has = wide_child_step(nrow, k, org, inv_d, bt, cidx, skip)
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, target, skip)
        idx = jnp.where(active, nxt, idx)
        return idx, bt, bs, bu, bv, it + 1

    init = (
        jnp.full((r,), base, jnp.int32),
        jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)).astype(jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.int32(0),
    )
    idx, bt, bs, bu, bv, _ = jax.lax.while_loop(cond, body, init)
    bt = jnp.where(bs >= 0, bt, vec.INF)
    return bt, bs, bu, bv


def traverse_packed_chunked(rows, leaf_rows, org, dirn, t_max, base, end,
                            leaf_size: int, chunk: int = 1 << 14):
    """Chunked wrapper: lax.map over sub-batches so each chunk's while_loop
    exits at its OWN max traversal depth — the lockstep-waste bound drops
    from max-over-all-rays to max-per-chunk (static shapes throughout).
    Chunks of coherent (sorted) rays converge in far fewer steps."""
    r = org.shape[0]
    if r <= chunk:
        return traverse_packed(rows, leaf_rows, org, dirn, t_max, base, end,
                               leaf_size)
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    pad = (-r) % chunk
    if pad:
        # padded rays carry t_max = -inf: every slab test fails (even with
        # origin inside a box, where tmin < 0) and the cursor skips
        # straight to `end` in one iteration
        org = jnp.concatenate([org, jnp.zeros((pad, 3), org.dtype)])
        dirn = jnp.concatenate([dirn, jnp.ones((pad, 3), dirn.dtype)])
        tm = jnp.concatenate([tm, jnp.full((pad,), -vec.INF, jnp.float32)])

    def one(args):
        o, d, t = args
        return traverse_packed(rows, leaf_rows, o, d, t, base, end, leaf_size)

    n = (r + pad) // chunk
    bt, bs, bu, bv = jax.lax.map(
        one,
        (org.reshape(n, chunk, 3), dirn.reshape(n, chunk, 3),
         tm.reshape(n, chunk)),
    )
    return bt.reshape(-1)[:r], bs.reshape(-1)[:r], bu.reshape(-1)[:r], \
        bv.reshape(-1)[:r]


def _gather_block(arr, start, width: int):
    """Per-ray contiguous block gather: arr (T, 3), start (R,) ->
    (R, width, 3). Leaf blocks are contiguous by construction so this is a
    strided gather, not a general scatter."""
    offs = jax.lax.broadcasted_iota(jnp.int32, (start.shape[0], width), 1)
    idx = start[:, None] + offs
    idx = jnp.clip(idx, 0, arr.shape[0] - 1)
    return arr[idx]
