"""Fixed-depth cluster-cull triangle intersector.

An alternative to divergent BVH walking (Tree.cs:67-128) for hardware where
serially-dependent row gathers dominate any per-ray tree walk while dense
broadcast arithmetic is nearly free. Instead of walking, every ray:

  1. slab-tests ALL cluster AABBs at once — a fused (rays x clusters)
     elementwise broadcast, zero gathers;
  2. takes the K nearest-entry candidate clusters (lax.top_k);
  3. brute-forces each candidate's triangle block — K *independent* row
     gathers (no serial dependency) + dense Möller-Trumbore on the VPU;
  4. rays whose candidate list overflowed (rare) finish with a t-bounded
     skip-link walk; resolved rays enter it with t_max = 0 and fall through
     in one step.

Cost is a fixed, divergence-free pipeline per ray — incoherent bounce rays
pay the same as coherent primaries, unlike the lockstep while_loop whose
cost is the max path length over the batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptsharp.accel import traverse
from ptsharp.core import vec


def _cull_and_intersect(c_bmin, c_bmax, c_rows, tris_per_cluster,
                        org, dirn, t_max, cbase, cend, k_cand):
    """One chunk: (Rc,) rays vs clusters [cbase, cend).
    Returns (t, slot, u, v, unresolved)."""
    rc = org.shape[0]
    n_c = c_bmin.shape[0]
    # small scenes can have fewer clusters than requested candidates:
    # top_k(k) requires k <= n; the overflow logic below already handles
    # n_hit <= k_cand, so clamping only shrinks the brute-force loop
    k_cand = min(k_cand, n_c)
    inv_d = 1.0 / jnp.where(
        jnp.abs(dirn) < 1e-30, jnp.where(dirn < 0, -1e-30, 1e-30), dirn
    )

    # (Rc, C) slab test, fused elementwise — no gathers
    def axis_minmax(ax):
        lo = (c_bmin[None, :, ax] - org[:, None, ax]) * inv_d[:, None, ax]
        hi = (c_bmax[None, :, ax] - org[:, None, ax]) * inv_d[:, None, ax]
        return jnp.minimum(lo, hi), jnp.maximum(lo, hi)

    l0, h0 = axis_minmax(0)
    l1, h1 = axis_minmax(1)
    l2, h2 = axis_minmax(2)
    tmin = jnp.maximum(jnp.maximum(l0, l1), l2)
    tmax = jnp.minimum(jnp.minimum(h0, h1), h2)
    ci = jax.lax.broadcasted_iota(jnp.int32, (rc, n_c), 1)
    in_range = (ci >= cbase) & (ci < cend)
    hit = in_range & (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_max[:, None])
    score = jnp.where(hit, jnp.maximum(tmin, 0.0), vec.INF)
    n_hit = jnp.sum(hit, axis=1)

    neg_tk, cand = jax.lax.top_k(-score, k_cand)  # (Rc, K) nearest-entry
    tk = -neg_tk

    best_t = t_max
    best_slot = jnp.full((rc,), -1, jnp.int32)
    best_u = jnp.zeros((rc,), jnp.float32)
    best_v = jnp.zeros((rc,), jnp.float32)

    def body(k, carry):
        bt, bs, bu, bv = carry
        c = cand[:, k]
        te = tk[:, k]
        valid = te < bt  # candidates behind the current hit are skipped
        t_lane, lane_best, u_lane, v_lane = traverse.leaf_intersect(
            c_rows, jnp.where(valid, c, 0), org, dirn, bt,
            tris_per_cluster, valid,
        )
        got = t_lane < bt
        bt = jnp.where(got, t_lane, bt)
        bs = jnp.where(got, c * tris_per_cluster + lane_best, bs)
        bu = jnp.where(got, u_lane, bu)
        bv = jnp.where(got, v_lane, bv)
        return bt, bs, bu, bv

    best_t, best_slot, best_u, best_v = jax.lax.fori_loop(
        0, k_cand, body, (best_t, best_slot, best_u, best_v)
    )
    # overflow: more than K clusters hit AND the K-th entry was still in
    # front of the best hit — a closer triangle could hide in cluster K+1
    unresolved = (n_hit > k_cand) & (tk[:, k_cand - 1] < best_t)
    return best_t, best_slot, best_u, best_v, unresolved


def intersect_clustered(scene_arrays, org, dirn, t_max, k_cand: int = 12,
                        chunk: int = 8192):
    """Full intersector: cluster cull + candidate brute force + bounded
    fallback walk. scene_arrays = (c_bmin, c_bmax, c_rows, tris_per_cluster,
    cbase, cend, u_rows, leaf_rows, nbase, nend, leaf_size).

    Returns (t, slot, u, v); t = INF, slot = -1 on miss.
    """
    (c_bmin, c_bmax, c_rows, tpc, cbase, cend,
     u_rows, leaf_rows, nbase, nend, leaf_size) = scene_arrays
    org = jax.lax.stop_gradient(org)
    dirn = jax.lax.stop_gradient(dirn)
    r = org.shape[0]
    tm = jnp.broadcast_to(
        jax.lax.stop_gradient(jnp.asarray(t_max, jnp.float32)), (r,)
    )

    def one(args):
        o, d, t = args
        bt, bs, bu, bv, unres = _cull_and_intersect(
            c_bmin, c_bmax, c_rows, tpc, o, d, t, cbase, cend, k_cand
        )
        # rare overflow rays finish with the t-bounded skip-link walk;
        # resolved rays pass t_max = -inf so even origin-inside-box rays
        # (tmin < 0) fail every slab test and fall through in one step
        wt, ws, wu, wv = traverse.traverse_packed(
            u_rows, leaf_rows, o, d, jnp.where(unres, bt, -vec.INF),
            nbase, nend, leaf_size,
        )
        got = wt < bt
        return (
            jnp.where(got, wt, bt),
            jnp.where(got, ws, bs),
            jnp.where(got, wu, bu),
            jnp.where(got, wv, bv),
        )

    if r <= chunk:
        bt, bs, bu, bv = one((org, dirn, tm))
    else:
        pad = (-r) % chunk
        if pad:
            org = jnp.concatenate([org, jnp.zeros((pad, 3), org.dtype)])
            dirn = jnp.concatenate([dirn, jnp.ones((pad, 3), dirn.dtype)])
            tm = jnp.concatenate([tm, jnp.zeros((pad,), jnp.float32)])
        n = (r + pad) // chunk
        bt, bs, bu, bv = jax.lax.map(
            one,
            (org.reshape(n, chunk, 3), dirn.reshape(n, chunk, 3),
             tm.reshape(n, chunk)),
        )
        bt = bt.reshape(-1)[:r]
        bs = bs.reshape(-1)[:r]
        bu = bu.reshape(-1)[:r]
        bv = bv.reshape(-1)[:r]
    bt = jnp.where(bs >= 0, bt, vec.INF)
    return bt, bs, bu, bv
