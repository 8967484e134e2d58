"""Per-lane K-wide BVH traversal kernels for the GPU (Pallas, Triton route).

The XLA walk (`accel.traverse.traverse_wide`) advances a whole ray chunk in
lockstep: every `while_loop` iteration is a few fused kernels that read the
ray state from device memory, gather one node row per lane, write the state
back, and read back an `any(idx < end)` predicate. These kernels run the
same stackless skip-link walk with the ray state held in registers for the
whole traversal: one program walks BLOCK lanes until all of them leave the
tree (the per-thread while-while loop of Aila & Laine, HPG 2009, with no
stack since the skip links replace it).

Semantics match `traverse_wide` step for step: arrive at a node, slab-test
its own box, run the fixed-width Moeller-Trumbore leaf block on a leaf,
else jump to the first hit child (`wide_child_step`) or the skip link. The
tables are the XLA walk's own (`SceneData.w_rows`, `SceneData.leaf_rows`),
passed unblocked and read one field at a time with per-lane gathers.

Triton-lowering rules kept here: no `jnp.any` (reduce_or has no lowering;
use an int max), no value slicing (each field is its own `ref[idx, c]`
gather), and plain ref indexing rather than `load(ref.at[...])` so the
interpreter runs the same body on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ptsharp.core import vec
from ptsharp.geometry import primitives

BLOCK = 128       # lanes per program
NUM_WARPS = 4     # 128 lanes = 4 warps of 32 threads
MAX_ITERS = 65536  # same bound as the XLA walk


def _use_interpreter(interpret: bool | None) -> bool:
    """Interpret on the CPU (tests), compile on the GPU, refuse anything
    else: a Pallas kernel that silently fell back to the interpreter on an
    accelerator would run orders of magnitude slower."""
    if interpret is not None:
        return interpret
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"traverse_gpu: no traversal kernel for backend {backend!r}")


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _inv_dir(d):
    return 1.0 / jnp.where(jnp.abs(d) < 1e-30,
                           jnp.where(d < 0, -1e-30, 1e-30), d)


def _slab(ref, idx, col, o, inv):
    """Entry/exit distance of each lane's ray against the box whose
    (min xyz, max xyz) start at column `col` of row `idx`."""
    lo = [(ref[idx, col + a] - o[a]) * inv[a] for a in range(3)]
    hi = [(ref[idx, col + 3 + a] - o[a]) * inv[a] for a in range(3)]
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(lo[0], hi[0]),
                                   jnp.minimum(lo[1], hi[1])),
                       jnp.minimum(lo[2], hi[2]))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(lo[0], hi[0]),
                                   jnp.maximum(lo[1], hi[1])),
                       jnp.maximum(lo[2], hi[2]))
    return tmin, tmax


def _bits(ref, idx, col):
    return jax.lax.bitcast_convert_type(ref[idx, col], jnp.int32)


def _triangle(leaf_ref, blk, j, o, d):
    """Moeller-Trumbore for slot j of each lane's leaf row: (t, u, v, ok)
    with the same arithmetic as `traverse.leaf_intersect`."""
    c = j * 9
    v0 = [leaf_ref[blk, c + a] for a in range(3)]
    e1 = [leaf_ref[blk, c + 3 + a] for a in range(3)]
    e2 = [leaf_ref[blk, c + 6 + a] for a in range(3)]
    h = [d[1] * e2[2] - d[2] * e2[1],
         d[2] * e2[0] - d[0] * e2[2],
         d[0] * e2[1] - d[1] * e2[0]]
    det = e1[0] * h[0] + e1[1] * h[1] + e1[2] * h[2]
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    s = [o[a] - v0[a] for a in range(3)]
    u = (s[0] * h[0] + s[1] * h[1] + s[2] * h[2]) * inv_det
    q = [s[1] * e1[2] - s[2] * e1[1],
         s[2] * e1[0] - s[0] * e1[2],
         s[0] * e1[1] - s[1] * e1[0]]
    v = (d[0] * q[0] + d[1] * q[1] + d[2] * q[2]) * inv_det
    t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det
    ok = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > primitives.EPS_T))
    return t, u, v, ok


def _child_target(rows_ref, idx, k, o, inv, bt, skip):
    """`traverse.wide_child_step` per lane: the lowest preorder index among
    the hit children, or the skip link when none is hit."""
    big = jnp.int32(2**31 - 1)
    target = jnp.full(idx.shape, big, jnp.int32)
    for j in range(k):
        ctmin, ctmax = _slab(rows_ref, idx, 9 + 6 * j, o, inv)
        cidx = _bits(rows_ref, idx, 9 + 6 * k + j)
        chit = (ctmax >= jnp.maximum(ctmin, 0.0)) & (ctmin < bt) & (cidx > 0)
        target = jnp.minimum(target, jnp.where(chit, cidx, big))
    return jnp.where(target < big, target, skip)


def _ray_block(refs):
    o = [r[...] for r in refs[:3]]
    d = [r[...] for r in refs[3:6]]
    return o, d, [_inv_dir(x) for x in d]


def _closest_kernel(be_ref, rows_ref, leaf_ref, ox, oy, oz, dx, dy, dz, tm,
                    t_out, s_out, u_out, v_out, *, k, leaf_size):
    o, d, inv = _ray_block((ox, oy, oz, dx, dy, dz))
    base = be_ref[0]
    end = be_ref[1]

    def cond(s):
        idx, *_, it = s
        return _any(idx < end) & (it < MAX_ITERS)

    def body(s):
        idx, bt, bs, bu, bv, it = s
        active = idx < end
        safe = jnp.where(active, idx, base)
        tmin, tmax = _slab(rows_ref, safe, 0, o, inv)
        box_hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < bt)
        first = _bits(rows_ref, safe, 6)
        cnt = _bits(rows_ref, safe, 7) & 0xFF
        skip = _bits(rows_ref, safe, 8)
        is_leaf = cnt > 0
        do_leaf = active & box_hit & is_leaf

        def leaf(c):
            bt, bs, bu, bv = c
            blk = jnp.where(do_leaf, first // leaf_size, 0)
            for j in range(leaf_size):
                t, u, v, ok = _triangle(leaf_ref, blk, j, o, d)
                got = do_leaf & ok & (t < bt)
                bt = jnp.where(got, t, bt)
                bs = jnp.where(got, first + j, bs)
                bu = jnp.where(got, u, bu)
                bv = jnp.where(got, v, bv)
            return bt, bs, bu, bv

        bt, bs, bu, bv = jax.lax.cond(_any(do_leaf), leaf, lambda c: c,
                                      (bt, bs, bu, bv))
        target = _child_target(rows_ref, safe, k, o, inv, bt, skip)
        nxt = jnp.where(box_hit & ~is_leaf, target, skip)
        return jnp.where(active, nxt, idx), bt, bs, bu, bv, it + 1

    n = tm.shape[0]
    init = (jnp.full((n,), base, jnp.int32), tm[...],
            jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), jnp.float32),
            jnp.zeros((n,), jnp.float32), jnp.int32(0))
    _idx, bt, bs, bu, bv, _it = jax.lax.while_loop(cond, body, init)
    t_out[...] = jnp.where(bs >= 0, bt, vec.INF)
    s_out[...] = bs
    u_out[...] = bu
    v_out[...] = bv


def _anyhit_kernel(be_ref, rows_ref, leaf_ref, ox, oy, oz, dx, dy, dz, tc,
                   occ_out, *, k, leaf_size):
    o, d, inv = _ray_block((ox, oy, oz, dx, dy, dz))
    base = be_ref[0]
    end = be_ref[1]
    bt = tc[...]

    def cond(s):
        idx, _occ, it = s
        return _any(idx < end) & (it < MAX_ITERS)

    def body(s):
        idx, occ, it = s
        active = idx < end
        safe = jnp.where(active, idx, base)
        tmin, tmax = _slab(rows_ref, safe, 0, o, inv)
        box_hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < bt)
        first = _bits(rows_ref, safe, 6)
        cnt = _bits(rows_ref, safe, 7) & 0xFF
        skip = _bits(rows_ref, safe, 8)
        is_leaf = cnt > 0
        do_leaf = active & box_hit & is_leaf

        def leaf(hit):
            blk = jnp.where(do_leaf, first // leaf_size, 0)
            for j in range(leaf_size):
                t, _u, _v, ok = _triangle(leaf_ref, blk, j, o, d)
                hit = hit | (do_leaf & ok & (t < bt))
            return hit

        hit = jax.lax.cond(_any(do_leaf), leaf, lambda h: h,
                           jnp.zeros(idx.shape, jnp.bool_))
        target = _child_target(rows_ref, safe, k, o, inv, bt, skip)
        nxt = jnp.where(box_hit & ~is_leaf, target, skip)
        # a lane retires on its first accepted hit
        nxt = jnp.where(hit, end, nxt)
        return (jnp.where(active, nxt, idx),
                jnp.where(hit, 1, occ), it + 1)

    n = bt.shape[0]
    init = (jnp.full((n,), base, jnp.int32), jnp.zeros((n,), jnp.int32),
            jnp.int32(0))
    _idx, occ, _it = jax.lax.while_loop(cond, body, init)
    occ_out[...] = occ


def _call(kernel, name, n_out, rows, leaf_rows, org, dirn, bound, base, end,
          out_dtypes, interpret, **static):
    """Pad the wavefront to whole blocks (pad lanes carry bound = -inf, so
    they fail the root's box test and retire in one step), split it into
    per-axis lane vectors and launch one program per BLOCK lanes."""
    r = org.shape[0]
    rp = -(-r // BLOCK) * BLOCK
    pad = rp - r
    bound = jnp.broadcast_to(jnp.asarray(bound, jnp.float32), (r,))
    if pad:
        org = jnp.concatenate([org, jnp.zeros((pad, 3), org.dtype)])
        dirn = jnp.concatenate([dirn, jnp.ones((pad, 3), dirn.dtype)])
        bound = jnp.concatenate(
            [bound, jnp.full((pad,), -vec.INF, jnp.float32)])
    lanes = [org[:, a].astype(jnp.float32) for a in range(3)] + \
        [dirn[:, a].astype(jnp.float32) for a in range(3)] + [bound]
    be = jnp.stack([jnp.asarray(base, jnp.int32),
                    jnp.asarray(end, jnp.int32)])
    lane_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    table_spec = pl.BlockSpec(memory_space=pl.ANY)
    outs = pl.pallas_call(
        functools.partial(kernel, **static),
        out_shape=[jax.ShapeDtypeStruct((rp,), dt) for dt in out_dtypes],
        grid=(rp // BLOCK,),
        in_specs=[table_spec] * 3 + [lane_spec] * 7,
        out_specs=[lane_spec] * n_out,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=_use_interpreter(interpret),
        name=name,
    )(be, rows, leaf_rows, *lanes)
    return [x[:r] for x in outs]


def closest_hit(rows, leaf_rows, org, dirn, t_max, base, end,
                leaf_size: int, k: int, interpret: bool | None = None):
    """Drop-in for `traverse.traverse_wide`: closest hit of each
    ray (R, 3) against wide nodes [base, end). Returns (t, slot, u, v);
    t = INF and slot = -1 on a miss. `interpret` None = decided by the
    backend (CPU interprets, GPU compiles)."""
    org, dirn, t_max, rows, leaf_rows = jax.lax.stop_gradient(
        (org, dirn, t_max, rows, leaf_rows))
    t, s, u, v = _call(
        _closest_kernel, "wide_closest_hit", 4, rows, leaf_rows, org, dirn,
        t_max, base, end,
        (jnp.float32, jnp.int32, jnp.float32, jnp.float32), interpret,
        k=k, leaf_size=leaf_size)
    return t, s, u, v


def occluded(rows, leaf_rows, org, dirn, t_cut, base, end, leaf_size: int,
             k: int, interpret: bool | None = None):
    """Any-hit: True where some triangle of nodes [base, end) lies at
    t in (EPS_T, t_cut). A lane stops at its first accepted hit."""
    org, dirn, t_cut, rows, leaf_rows = jax.lax.stop_gradient(
        (org, dirn, t_cut, rows, leaf_rows))
    (occ,) = _call(
        _anyhit_kernel, "wide_any_hit", 1, rows, leaf_rows, org, dirn,
        t_cut, base, end, (jnp.int32,), interpret, k=k, leaf_size=leaf_size)
    return occ > 0
