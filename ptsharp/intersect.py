"""Scene-wide closest-hit over ray wavefronts.

The replacement for the reference's Scene.Intersect -> k-d tree descent ->
virtual IShape.Intersect chain (Scene.cs:75-79, Tree.cs:67-128). Two static
dispatch tiers, chosen per scene at build time:

  * small scenes: per primitive *type* the whole batch is intersected in
    one vectorized pass (brute-force SoA tables for analytic primitives,
    packed skip-link BVH walk or cluster-cull intersector for triangles,
    while-loop marches for SDF/volume), then a min-t select across types;
  * instancing-heavy / large scenes (`scene.use_tlas`): one unified
    traversal (`traverse_scene`) over a TLAS whose typed singleton leaves
    cover analytic primitives and re-enter per-mesh BLASes for instances
    (Tree.cs:22-42 + TransformedShape.cs:43-72 semantics).

Python-level `if` on table sizes specializes each scene's kernel at trace
time — absent types cost nothing.

Hit record semantics mirror Hit.Info (Hit.cs:26-55): shading normal flipped
toward the ray, `inside` flag set on flip except for SDF/volume shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ptsharp.core import vec
from ptsharp.geometry import function as fn_mod
from ptsharp.geometry import primitives, sdf as sdf_mod, volume as vol_mod
from ptsharp.accel import traverse
from ptsharp.pallas import traverse_gpu
from ptsharp.scene import (
    PT_CUBE,
    PT_CYLINDER,
    PT_FUNCTION,
    PT_INSTANCE,
    PT_NONE,
    PT_PLANE,
    PT_SDF,
    PT_SPHERE,
    PT_TRIANGLE,
    PT_VOLUME,
    SceneData,
)

INF = vec.INF


# ---------------------------------------------------------------------------
# Elementwise single-primitive tests (per-ray gathered parameters): org/dirn
# (R, 3) against per-ray primitive params. Same math as the batched tables in
# geometry/primitives.py but broadcast ray-wise for TLAS leaf visits.
# ---------------------------------------------------------------------------


def _sphere_t1(o, d, c, rad):
    oc = o - c
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(oc * d, axis=-1)
    cq = jnp.sum(oc * oc, axis=-1) - rad * rad
    disc = b * b - 4.0 * a * cq
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 0.5 / jnp.maximum(a, 1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = jnp.where(t0 > primitives.EPS_T, t0,
                  jnp.where(t1 > primitives.EPS_T, t1, INF))
    return jnp.where(disc > 0.0, t, INF)


def _cube_t1(o, d, lo, hi):
    invd = primitives._safe_div(jnp.ones_like(d), d)
    n = (lo - o) * invd
    f = (hi - o) * invd
    t0 = jnp.max(jnp.minimum(n, f), axis=-1)
    t1 = jnp.min(jnp.maximum(n, f), axis=-1)
    ok = (t0 > primitives.EPS_T) & (t0 < t1)
    return jnp.where(ok, t0, INF)


def _cyl_t1(o, d, rad, z0, z1):
    tz0 = primitives._safe_div(z0 - o[..., 2], d[..., 2])
    tz1 = primitives._safe_div(z1 - o[..., 2], d[..., 2])

    def cap_ok(tc):
        px = o[..., 0] + d[..., 0] * tc
        py = o[..., 1] + d[..., 1] * tc
        return (tc > primitives.EPS_T) & (px * px + py * py <= rad * rad)

    t_top = jnp.where(cap_ok(tz1), tz1, INF)
    t_bot = jnp.where(cap_ok(tz0), tz0, INF)
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1])
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - rad * rad
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 0.5 / jnp.maximum(a, 1e-30)
    tl0 = (-b - sq) * inv2a
    tl1 = (-b + sq) * inv2a

    def lat_ok(tl):
        z = o[..., 2] + d[..., 2] * tl
        return (tl > primitives.EPS_T) & (z >= z0) & (z <= z1) & (disc >= 0.0)

    t_lat = jnp.where(lat_ok(tl0), tl0, jnp.where(lat_ok(tl1), tl1, INF))
    return jnp.minimum(jnp.minimum(t_top, t_bot), t_lat)


class Hit(NamedTuple):
    """Per-ray closest hit. pindex is the within-type primitive index
    (sorted-triangle index for meshes); inst is the mesh instance id
    (-1 otherwise)."""

    t: jnp.ndarray
    ptype: jnp.ndarray
    pindex: jnp.ndarray
    inst: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray


class HitInfo(NamedTuple):
    """Shading data for hit rays (garbage where ptype == PT_NONE)."""

    position: jnp.ndarray
    normal: jnp.ndarray  # flipped toward the ray (Hit.cs:36-47)
    inside: jnp.ndarray
    mat_id: jnp.ndarray
    tex_u: jnp.ndarray
    tex_v: jnp.ndarray


# Instance transforms run at full f32 precision: a GPU may otherwise run an
# f32 matrix product in TF32 (~3 decimal digits), and origins off by ~1e-3
# relative miss thin geometry and cause shadow acne.
_EXACT = jax.lax.Precision.HIGHEST


def _xform_point(aff, p):
    """aff (..., 3, 4) applied to points p (..., 3)."""
    return jnp.einsum("...ij,...j->...i", aff[..., :3], p,
                      precision=_EXACT) + aff[..., 3]


def _xform_dir(aff, d):
    return jnp.einsum("...ij,...j->...i", aff[..., :3], d, precision=_EXACT)


def _xform_normal(aff_inv, n):
    """normal transform = inverse-transpose of the linear part; aff_inv is
    already the world->object affine, so n_world ~ aff_inv_lin^T n_obj."""
    return vec.normalize(jnp.einsum("...ji,...j->...i", aff_inv[..., :3], n,
                                    precision=_EXACT))


def traverse_scene(scene: SceneData, org_w, dir_w, t_max,
                   max_iters: int = 65536, wide: bool | None = None):
    """Unified single-pass traversal of the whole scene accelerator: a TLAS
    over analytic primitives + mesh instances whose instance leaves re-enter
    the per-mesh BLAS (the flattened replacement for the reference's
    top-level k-d tree, Tree.cs:22-42 / Scene.cs:56-66, plus
    TransformedShape re-entry, TransformedShape.cs:43-72).

    One int32 cursor per ray walks the unified node array [u_* fields];
    entering an instance leaf swaps the ray into object space and jumps to
    the BLAS range, and a one-deep return slot pops back to the TLAS when
    the BLAS finishes. t is parametric in the *world* direction scale (local
    directions are unnormalized), so comparisons across spaces are exact.

    Returns (t, kind, index, inst, u, v); kind == PT_NONE where nothing beat
    t_max.
    """
    # discrete traversal is detached (gradients flow via shading)
    org_w = jax.lax.stop_gradient(org_w)
    dir_w = jax.lax.stop_gradient(dir_w)
    t_max = jax.lax.stop_gradient(t_max)
    r = org_w.shape[0]
    # wide (default): K-wide node rows — one gather per arrived node
    # decides a K-way step (see accel/wide.py); "walk" falls back to the
    # binary packed rows.
    if wide is None:
        wide = scene.intersector != "walk"
    kw = scene.wide_k
    rows = scene.w_rows if wide else scene.u_rows
    inst_base_t = scene.w_inst_base if wide else scene.u_inst_base
    inst_end_t = scene.w_inst_end if wide else scene.u_inst_end
    tlas_end = scene.w_tlas_end if wide else scene.tlas_end
    assert tlas_end > 0, "traverse_scene requires a built TLAS"
    leaf = scene.max_leaf
    n_inst = scene.inst_inv.shape[0]
    has_sph = scene.sphere_center.shape[0] > 0
    has_cube = scene.cube_min.shape[0] > 0
    has_cyl = scene.cyl_radius.shape[0] > 0
    has_tri = scene.tri_v0.shape[0] > 0 and n_inst > 0

    def cond(s):
        idx, _ret, inst, *_rest, it = s
        return jnp.logical_and(
            jnp.any((inst >= 0) | (idx < tlas_end)), it < max_iters
        )

    def body(s):
        idx, ret, inst, bend, o_l, d_l, bt, bk, bi, binst, bu, bv, it = s
        active = (inst >= 0) | (idx < tlas_end)
        safe = jnp.where(active, idx, 0)
        nrow = rows[safe]  # (R, W) — one gather per node
        if wide:
            first, k, cnt, skp, cidx = traverse.unpack_wide_bits(nrow, kw)
        else:
            first, skp, k, cnt = traverse.unpack_bits(nrow)

        inv_d = 1.0 / jnp.where(
            jnp.abs(d_l) < 1e-30, jnp.where(d_l < 0, -1e-30, 1e-30), d_l
        )
        slo = (nrow[:, 0:3] - o_l) * inv_d
        shi = (nrow[:, 3:6] - o_l) * inv_d
        tmin = jnp.max(jnp.minimum(slo, shi), axis=-1)
        tmax = jnp.min(jnp.maximum(slo, shi), axis=-1)
        box_hit = active & (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < bt)

        # --- triangle leaf: one packed leaf-row per ray --------------------
        if has_tri:
            do_tri = box_hit & (k == PT_TRIANGLE)
            t_lane, lane_best, u_lane, v_lane = traverse.leaf_intersect(
                scene.leaf_rows, jnp.where(do_tri, first // leaf, 0),
                o_l, d_l, bt, leaf, do_tri,
            )
            got = t_lane < bt
            bt = jnp.where(got, t_lane, bt)
            bk = jnp.where(got, PT_TRIANGLE, bk)
            bi = jnp.where(got, first + lane_best, bi)
            binst = jnp.where(got, inst, binst)
            bu = jnp.where(got, u_lane, bu)
            bv = jnp.where(got, v_lane, bv)

        # --- analytic singleton leaves (world space; never inside a BLAS) -
        if has_sph:
            do_s = box_hit & (k == PT_SPHERE)
            pi = jnp.clip(first, 0, scene.sphere_center.shape[0] - 1)
            c = scene.sphere_center[pi]
            rad = scene.sphere_radius[pi]
            if scene.sphere_xform:
                invm = scene.sphere_inv[pi]
                o_s = _xform_point(invm, o_l)
                d_s = _xform_dir(invm, d_l)
            else:
                o_s, d_s = o_l, d_l
            t = _sphere_t1(o_s, d_s, c, rad)
            got = do_s & (t < bt)
            bt = jnp.where(got, t, bt)
            bk = jnp.where(got, PT_SPHERE, bk)
            bi = jnp.where(got, first, bi)
            binst = jnp.where(got, -1, binst)

        if has_cube:
            do_c = box_hit & (k == PT_CUBE)
            pi = jnp.clip(first, 0, scene.cube_min.shape[0] - 1)
            clo = scene.cube_min[pi]
            chi = scene.cube_max[pi]
            if scene.cube_xform:
                invm = scene.cube_inv[pi]
                o_c = _xform_point(invm, o_l)
                d_c = _xform_dir(invm, d_l)
            else:
                o_c, d_c = o_l, d_l
            t = _cube_t1(o_c, d_c, clo, chi)
            got = do_c & (t < bt)
            bt = jnp.where(got, t, bt)
            bk = jnp.where(got, PT_CUBE, bk)
            bi = jnp.where(got, first, bi)
            binst = jnp.where(got, -1, binst)

        if has_cyl:
            do_y = box_hit & (k == PT_CYLINDER)
            pi = jnp.clip(first, 0, scene.cyl_radius.shape[0] - 1)
            rad = scene.cyl_radius[pi]
            z0 = scene.cyl_z0[pi]
            z1 = scene.cyl_z1[pi]
            if scene.cyl_xform:
                invm = scene.cyl_inv[pi]
                o_y = _xform_point(invm, o_l)
                d_y = _xform_dir(invm, d_l)
            else:
                o_y, d_y = o_l, d_l
            t = _cyl_t1(o_y, d_y, rad, z0, z1)
            got = do_y & (t < bt)
            bt = jnp.where(got, t, bt)
            bk = jnp.where(got, PT_CYLINDER, bk)
            bi = jnp.where(got, first, bi)
            binst = jnp.where(got, -1, binst)

        # --- advance cursor / enter-exit BLAS ------------------------------
        descend = box_hit & (k == PT_NONE)
        if wide:
            target, _ = traverse.wide_child_step(
                nrow, kw, o_l, inv_d, bt, cidx, skp
            )
            nxt = jnp.where(descend, target, skp)
        else:
            nxt = jnp.where(descend, idx + 1, skp)
        if n_inst > 0:
            enter = box_hit & (k == PT_INSTANCE)
            ii = jnp.clip(first, 0, n_inst - 1)
            base = inst_base_t[ii]
            iend = inst_end_t[ii]
            invm = scene.inst_inv[ii]
            o_i = _xform_point(invm, org_w)
            d_i = _xform_dir(invm, dir_w)
            nxt = jnp.where(enter, base, nxt)
            ret = jnp.where(enter, skp, ret)
            bend = jnp.where(enter, iend, bend)
            inst_n = jnp.where(enter, ii, inst)
            o_n = jnp.where(enter[:, None], o_i, o_l)
            d_n = jnp.where(enter[:, None], d_i, d_l)
            pop = active & (inst_n >= 0) & (nxt >= bend)
            nxt = jnp.where(pop, ret, nxt)
            inst_n = jnp.where(pop, -1, inst_n)
            o_n = jnp.where(pop[:, None], org_w, o_n)
            d_n = jnp.where(pop[:, None], dir_w, d_n)
        else:
            inst_n, o_n, d_n = inst, o_l, d_l
        idx = jnp.where(active, nxt, idx)
        return (idx, ret, inst_n, bend, o_n, d_n, bt, bk, bi, binst, bu, bv,
                it + 1)

    bt0 = (
        jnp.full((r,), t_max, jnp.float32)
        if jnp.ndim(t_max) == 0
        else t_max.astype(jnp.float32)
    )
    init = (
        jnp.zeros((r,), jnp.int32),                 # idx
        jnp.full((r,), tlas_end, jnp.int32),        # ret
        jnp.full((r,), -1, jnp.int32),              # inst
        jnp.zeros((r,), jnp.int32),                 # bend
        org_w, dir_w,                               # o_l, d_l
        bt0,                                        # best t
        jnp.zeros((r,), jnp.int32),                 # best kind (PT_NONE)
        jnp.full((r,), -1, jnp.int32),              # best index
        jnp.full((r,), -1, jnp.int32),              # best inst
        jnp.zeros((r,), jnp.float32),               # best u
        jnp.zeros((r,), jnp.float32),               # best v
        jnp.int32(0),
    )
    out = jax.lax.while_loop(cond, body, init)
    _, _, _, _, _, _, bt, bk, bi, binst, bu, bv, _ = out
    bt = jnp.where(bk == PT_NONE, INF, bt)
    return bt, bk, bi, binst, bu, bv


def closest_hit(scene: SceneData, org, dirn, t_max=None) -> Hit:
    """org/dirn (R, 3), unit directions. Returns the closest hit per ray.

    t_max (scalar or (R,)) bounds the search: hits beyond it are ignored
    (shadow rays pass their light distance so traversal prunes everything
    behind the light)."""
    r = org.shape[0]
    if t_max is None:
        best_t = jnp.full(r, INF, jnp.float32)
    else:
        best_t = jnp.broadcast_to(
            jax.lax.stop_gradient(jnp.asarray(t_max, jnp.float32)), (r,)
        )
    best_type = jnp.zeros(r, jnp.int32)
    best_idx = jnp.full(r, -1, jnp.int32)
    best_inst = jnp.full(r, -1, jnp.int32)
    best_u = jnp.zeros(r, jnp.float32)
    best_v = jnp.zeros(r, jnp.float32)

    def take(t_new, ptype, pidx, inst=None, u=None, v=None):
        nonlocal best_t, best_type, best_idx, best_inst, best_u, best_v
        better = t_new < best_t
        best_t = jnp.where(better, t_new, best_t)
        best_type = jnp.where(better, ptype, best_type)
        best_idx = jnp.where(better, pidx, best_idx)
        best_inst = jnp.where(better, inst if inst is not None else -1, best_inst)
        best_u = jnp.where(better, u if u is not None else 0.0, best_u)
        best_v = jnp.where(better, v if v is not None else 0.0, best_v)

    o1 = org[:, None, :]
    d1 = dirn[:, None, :]

    # --- planes (infinite: never in the TLAS) ------------------------------
    if scene.plane_point.shape[0] > 0:
        ts = primitives.intersect_planes(o1, d1, scene.plane_point, scene.plane_normal)
        idx = jnp.argmin(ts, axis=1)
        tmin = jnp.min(ts, axis=1)
        take(tmin, PT_PLANE, idx.astype(jnp.int32))

    if scene.use_tlas:
        # --- unified TLAS traversal: analytic prims + mesh instances ------
        t, k, i, binst, u, v = traverse_scene(scene, org, dirn, best_t)
        take(t, k, i, inst=binst, u=u, v=v)

    # --- spheres ----------------------------------------------------------
    if not scene.use_tlas and scene.sphere_center.shape[0] > 0:
        if scene.sphere_xform:
            o = _xform_point(scene.sphere_inv[None], o1)
            d = _xform_dir(scene.sphere_inv[None], d1)
        else:
            o, d = o1, d1
        ts = primitives.intersect_spheres(o, d, scene.sphere_center, scene.sphere_radius)
        idx = jnp.argmin(ts, axis=1)
        tmin = jnp.min(ts, axis=1)
        take(tmin, PT_SPHERE, idx.astype(jnp.int32))

    # --- cubes ------------------------------------------------------------
    if not scene.use_tlas and scene.cube_min.shape[0] > 0:
        if scene.cube_xform:
            o = _xform_point(scene.cube_inv[None], o1)
            d = _xform_dir(scene.cube_inv[None], d1)
        else:
            o, d = o1, d1
        ts = primitives.intersect_cubes(o, d, scene.cube_min, scene.cube_max)
        idx = jnp.argmin(ts, axis=1)
        tmin = jnp.min(ts, axis=1)
        take(tmin, PT_CUBE, idx.astype(jnp.int32))

    # --- cylinders --------------------------------------------------------
    if not scene.use_tlas and scene.cyl_radius.shape[0] > 0:
        if scene.cyl_xform:
            o = _xform_point(scene.cyl_inv[None], o1)
            d = _xform_dir(scene.cyl_inv[None], d1)
        else:
            o, d = o1, d1
        ts = primitives.intersect_cylinders(o, d, scene.cyl_radius, scene.cyl_z0, scene.cyl_z1)
        idx = jnp.argmin(ts, axis=1)
        tmin = jnp.min(ts, axis=1)
        take(tmin, PT_CYLINDER, idx.astype(jnp.int32))

    # --- mesh instances: one object-space traversal per instance ---------
    n_inst = scene.inst_inv.shape[0]
    if not scene.use_tlas and n_inst > 0:
        from ptsharp.accel import cluster as cluster_mod

        tpc = scene.cluster_rows.shape[1] // 9 if scene.cluster_rows.size else 0
        for i in range(n_inst):
            inv = scene.inst_inv[i]
            o = _xform_point(inv[None], org)
            d = _xform_dir(inv[None], dirn)
            if scene.intersector == "cluster" and tpc:
                t, slot, u, v = cluster_mod.intersect_clustered(
                    (scene.cluster_bmin, scene.cluster_bmax,
                     scene.cluster_rows, tpc,
                     scene.inst_cluster_base[i], scene.inst_cluster_end[i],
                     scene.u_rows, scene.leaf_rows,
                     scene.u_inst_base[i], scene.u_inst_end[i],
                     scene.max_leaf),
                    o, d, best_t,
                )
            elif scene.intersector == "walk":
                t, slot, u, v = traverse.traverse_packed_chunked(
                    scene.u_rows, scene.leaf_rows, o, d, best_t,
                    scene.u_inst_base[i], scene.u_inst_end[i], scene.max_leaf,
                )
            else:
                # "wide": the XLA walk, one lockstep loop over the whole
                # wavefront; "pallas": the same walk as one per-lane GPU
                # kernel over the same tables
                walk = (traverse_gpu.closest_hit
                        if scene.intersector == "pallas"
                        else traverse.traverse_wide)
                t, slot, u, v = walk(
                    scene.w_rows, scene.leaf_rows, o, d, best_t,
                    scene.w_inst_base[i], scene.w_inst_end[i],
                    scene.max_leaf, scene.wide_k,
                )
            take(t, PT_TRIANGLE, slot, inst=jnp.int32(i), u=u, v=v)

    # --- SDF objects (sphere trace) ---------------------------------------
    for i, (sdf_obj, _mid, lo, hi) in enumerate(scene.sdf_objects):
        lo_a = jnp.asarray(lo, jnp.float32)
        hi_a = jnp.asarray(hi, jnp.float32)
        te, tx = primitives.box_entry_exit(org, dirn, lo_a, hi_a)
        tx = jnp.minimum(tx, best_t)
        t = sdf_mod.sphere_trace(sdf_obj, org, dirn, te, tx)
        take(t, PT_SDF, jnp.int32(i))

    # --- volumes ----------------------------------------------------------
    for i, vol in enumerate(scene.volumes):
        lo_a = jnp.asarray(vol.bmin, jnp.float32)
        hi_a = jnp.asarray(vol.bmax, jnp.float32)
        te, tx = primitives.box_entry_exit(org, dirn, lo_a, hi_a)
        tx = jnp.minimum(tx, best_t)
        t = vol_mod.intersect(scene.volume_data[i], vol, org, dirn, te, tx)
        take(t, PT_VOLUME, jnp.int32(i))

    # --- heightfield functions --------------------------------------------
    for i, (hf, _mid) in enumerate(scene.functions):
        lo_a = jnp.asarray(hf.bmin, jnp.float32)
        hi_a = jnp.asarray(hf.bmax, jnp.float32)
        te, tx = primitives.box_entry_exit(org, dirn, lo_a, hi_a)
        tx = jnp.minimum(tx, best_t)
        t = fn_mod.intersect(hf, org, dirn, te, tx)
        take(t, PT_FUNCTION, jnp.int32(i))

    if t_max is not None:
        best_t = jnp.where(best_type == PT_NONE, INF, best_t)
    return Hit(best_t, best_type, best_idx, best_inst, best_u, best_v)


def _any_below(ts, tc):
    """Whether any of a ray's candidate hits ts (R, N) lies below its bound
    tc (R,), as a float min. On the H100, XLA fused the boolean form,
    `jnp.any(ts < tc[:, None], axis=1)`, into a Triton kernel that
    returned wrong, run-to-run different shadows (PERF.md)."""
    return jnp.min(ts, axis=1) < tc


def occlusion_query(scene: SceneData, org, dirn, t_cut) -> jnp.ndarray:
    """Boolean any-hit visibility test: True where ANY scene surface
    intersects the ray at t in (eps, t_cut). The NEE shadow-ray semantics
    of the reference (Sampler.cs:261-265 — "the closest hit must be the
    sampled light") reduce to this boolean once the caller knows the
    light's own hit distance analytically: visible = light hit exists AND
    nothing else lies in front of it.

    Mesh instances use the early-exit any-hit kernel when the scene's
    intersector is "pallas" (a lane retires on its first accepted hit).
    Everything else reuses the bounded closest-hit machinery — the t_cut
    bound already prunes traversal past the light. Discrete; always
    detached.

    t_cut may be scalar or (R,); lanes with t_cut <= 0 short-circuit to
    not-occluded everywhere.
    """
    org = jax.lax.stop_gradient(org)
    dirn = jax.lax.stop_gradient(dirn)
    r = org.shape[0]
    tc = jnp.broadcast_to(
        jax.lax.stop_gradient(jnp.asarray(t_cut, jnp.float32)), (r,)
    )
    occ = jnp.zeros(r, bool)

    def cut():
        # already-occluded lanes carry a -INF bound: every subsequent
        # traversal's box/march tests fail instantly for them
        return jnp.where(occ, -INF, tc)

    o1 = org[:, None, :]
    d1 = dirn[:, None, :]

    # planes are never in the TLAS
    if scene.plane_point.shape[0] > 0:
        ts = primitives.intersect_planes(o1, d1, scene.plane_point,
                                         scene.plane_normal)
        occ = occ | _any_below(ts, tc)

    if scene.use_tlas:
        t, k, _i, _bi, _u, _v = traverse_scene(scene, org, dirn, cut())
        occ = occ | (k != PT_NONE)
    else:
        if scene.sphere_center.shape[0] > 0:
            if scene.sphere_xform:
                o = _xform_point(scene.sphere_inv[None], o1)
                d = _xform_dir(scene.sphere_inv[None], d1)
            else:
                o, d = o1, d1
            ts = primitives.intersect_spheres(
                o, d, scene.sphere_center, scene.sphere_radius)
            occ = occ | _any_below(ts, tc)
        if scene.cube_min.shape[0] > 0:
            if scene.cube_xform:
                o = _xform_point(scene.cube_inv[None], o1)
                d = _xform_dir(scene.cube_inv[None], d1)
            else:
                o, d = o1, d1
            ts = primitives.intersect_cubes(o, d, scene.cube_min,
                                            scene.cube_max)
            occ = occ | _any_below(ts, tc)
        if scene.cyl_radius.shape[0] > 0:
            if scene.cyl_xform:
                o = _xform_point(scene.cyl_inv[None], o1)
                d = _xform_dir(scene.cyl_inv[None], d1)
            else:
                o, d = o1, d1
            ts = primitives.intersect_cylinders(
                o, d, scene.cyl_radius, scene.cyl_z0, scene.cyl_z1)
            occ = occ | _any_below(ts, tc)

        if scene.inst_inv.shape[0] > 0 and scene.tri_v0.shape[0] > 0:
            for i in range(scene.inst_inv.shape[0]):
                inv = scene.inst_inv[i]
                o = _xform_point(inv[None], org)
                d = _xform_dir(inv[None], dirn)
                args = (scene.w_rows, scene.leaf_rows, o, d, cut(),
                        scene.w_inst_base[i], scene.w_inst_end[i],
                        scene.max_leaf, scene.wide_k)
                if scene.intersector == "pallas":
                    occ = occ | traverse_gpu.occluded(*args)
                else:
                    t, _s, _u, _v = traverse.traverse_wide(*args)
                    occ = occ | (t < INF)

    for i, (sdf_obj, _mid, lo, hi) in enumerate(scene.sdf_objects):
        lo_a = jnp.asarray(lo, jnp.float32)
        hi_a = jnp.asarray(hi, jnp.float32)
        te, tx = primitives.box_entry_exit(org, dirn, lo_a, hi_a)
        tx = jnp.minimum(tx, cut())
        t = sdf_mod.sphere_trace(sdf_obj, org, dirn, te, tx)
        occ = occ | (t < tc)

    for i, vol in enumerate(scene.volumes):
        lo_a = jnp.asarray(vol.bmin, jnp.float32)
        hi_a = jnp.asarray(vol.bmax, jnp.float32)
        te, tx = primitives.box_entry_exit(org, dirn, lo_a, hi_a)
        tx = jnp.minimum(tx, cut())
        t = vol_mod.intersect(scene.volume_data[i], vol, org, dirn, te, tx)
        occ = occ | (t < tc)

    for i, (hf, _mid) in enumerate(scene.functions):
        lo_a = jnp.asarray(hf.bmin, jnp.float32)
        hi_a = jnp.asarray(hf.bmax, jnp.float32)
        te, tx = primitives.box_entry_exit(org, dirn, lo_a, hi_a)
        tx = jnp.minimum(tx, cut())
        t = fn_mod.intersect(hf, org, dirn, te, tx)
        occ = occ | (t < tc)

    return occ


def light_hit_t(scene: SceneData, org, dirn, lidx) -> jnp.ndarray:
    """Analytic hit distance of each ray against ITS sampled light's
    primitive (lidx (R,) per-ray light index): the exact geometry the
    shadow ray must reach, computed without touching the accelerator.
    INF where the ray misses the light (a grazing soft-shadow sample —
    invisible by the reference's "must hit that light" rule). Triangle
    (mesh) lights are excluded: the caller already knows the sampled
    point's distance. Only valid for scenes whose lights are analytic
    primitives (light_types ⊆ {sphere, cube, cylinder, triangle})."""
    r = org.shape[0]
    t_light = jnp.full(r, INF, jnp.float32)
    pi = jnp.maximum(scene.light_pindex[lidx], 0)
    lt = scene.light_ptype[lidx]

    if PT_SPHERE in scene.light_types:
        pic = jnp.clip(pi, 0, scene.sphere_center.shape[0] - 1)
        if scene.sphere_xform:
            invm = scene.sphere_inv[pic]
            o_s = _xform_point(invm, org)
            d_s = _xform_dir(invm, dirn)
        else:
            o_s, d_s = org, dirn
        t = _sphere_t1(o_s, d_s, scene.sphere_center[pic],
                       scene.sphere_radius[pic])
        t_light = jnp.where(lt == PT_SPHERE, t, t_light)

    if PT_CUBE in scene.light_types:
        pic = jnp.clip(pi, 0, scene.cube_min.shape[0] - 1)
        if scene.cube_xform:
            invm = scene.cube_inv[pic]
            o_c = _xform_point(invm, org)
            d_c = _xform_dir(invm, dirn)
        else:
            o_c, d_c = org, dirn
        t = _cube_t1(o_c, d_c, scene.cube_min[pic], scene.cube_max[pic])
        t_light = jnp.where(lt == PT_CUBE, t, t_light)

    if PT_CYLINDER in scene.light_types:
        pic = jnp.clip(pi, 0, scene.cyl_radius.shape[0] - 1)
        if scene.cyl_xform:
            invm = scene.cyl_inv[pic]
            o_y = _xform_point(invm, org)
            d_y = _xform_dir(invm, dirn)
        else:
            o_y, d_y = org, dirn
        t = _cyl_t1(o_y, d_y, scene.cyl_radius[pic], scene.cyl_z0[pic],
                    scene.cyl_z1[pic])
        t_light = jnp.where(lt == PT_CYLINDER, t, t_light)

    return t_light


def hit_info(scene: SceneData, org, dirn, hit: Hit) -> HitInfo:
    """Compute shading data for the winning primitive of each ray. Every
    present type's info is computed masked and selected — branchless over
    the wavefront (types absent from the scene are skipped statically)."""
    r = org.shape[0]
    pos = org + dirn * hit.t[..., None]
    normal = jnp.zeros((r, 3), jnp.float32)
    # default up-normal avoids NaNs in the miss lanes
    normal = normal.at[:, 1].set(1.0)
    mat_id = jnp.zeros(r, jnp.int32)
    tex_u = jnp.zeros(r, jnp.float32)
    tex_v = jnp.zeros(r, jnp.float32)

    def sel(mask, new_n, new_m, new_u=None, new_v=None):
        nonlocal normal, mat_id, tex_u, tex_v
        normal = jnp.where(mask[:, None], new_n, normal)
        mat_id = jnp.where(mask, new_m, mat_id)
        if new_u is not None:
            tex_u = jnp.where(mask, new_u, tex_u)
        if new_v is not None:
            tex_v = jnp.where(mask, new_v, tex_v)

    idx = jnp.maximum(hit.pindex, 0)

    if scene.sphere_center.shape[0] > 0:
        m = hit.ptype == PT_SPHERE
        c = scene.sphere_center[idx]
        rad = scene.sphere_radius[idx]
        if scene.sphere_xform:
            inv = scene.sphere_inv[idx]
            p_obj = _xform_point(inv, pos)
            n_obj = vec.normalize(p_obj - c)
            n = _xform_normal(inv, n_obj)
            u, v = primitives.sphere_uv(p_obj, c, rad)
        else:
            n = primitives.sphere_normal(pos, c)
            u, v = primitives.sphere_uv(pos, c, rad)
        sel(m, n, scene.sphere_mat[idx], u, v)

    if scene.plane_point.shape[0] > 0:
        m = hit.ptype == PT_PLANE
        sel(m, scene.plane_normal[idx], scene.plane_mat[idx])

    if scene.cube_min.shape[0] > 0:
        m = hit.ptype == PT_CUBE
        lo = scene.cube_min[idx]
        hi = scene.cube_max[idx]
        if scene.cube_xform:
            inv = scene.cube_inv[idx]
            p_obj = _xform_point(inv, pos)
            n = _xform_normal(inv, primitives.cube_normal(p_obj, lo, hi))
            u, v = primitives.cube_uv(p_obj, lo, hi)
        else:
            n = primitives.cube_normal(pos, lo, hi)
            u, v = primitives.cube_uv(pos, lo, hi)
        sel(m, n, scene.cube_mat[idx], u, v)

    if scene.cyl_radius.shape[0] > 0:
        m = hit.ptype == PT_CYLINDER
        z0 = scene.cyl_z0[idx]
        z1 = scene.cyl_z1[idx]
        if scene.cyl_xform:
            inv = scene.cyl_inv[idx]
            p_obj = _xform_point(inv, pos)
            n = _xform_normal(inv, primitives.cylinder_normal(p_obj, z0, z1))
        else:
            n = primitives.cylinder_normal(pos, z0, z1)
        sel(m, n, scene.cyl_mat[idx])

    if scene.inst_inv.shape[0] > 0:
        m = hit.ptype == PT_TRIANGLE
        n0 = scene.tri_n0[idx]
        n1 = scene.tri_n1[idx]
        n2 = scene.tri_n2[idx]
        n_obj = vec.normalize(
            primitives.triangle_interpolate(n0, n1, n2, hit.u, hit.v)
        )
        uv = primitives.triangle_interpolate(
            scene.tri_uv0[idx], scene.tri_uv1[idx], scene.tri_uv2[idx],
            hit.u, hit.v,
        )
        inst = jnp.maximum(hit.inst, 0)
        over = scene.inst_mat[inst]
        tm = jnp.where(over >= 0, over, scene.tri_mat[idx])

        # tangent-space normal mapping + bump mapping
        # (Triangle.cs:142-186); only when the scene carries any maps
        mats = scene.materials
        if scene.has_surface_maps:  # static: set at scene build
            tri_mat_g = mats.gather(tm)
            duv1 = scene.tri_uv1[idx] - scene.tri_uv0[idx]
            duv2 = scene.tri_uv2[idx] - scene.tri_uv0[idx]
            e1 = scene.tri_e1[idx]
            e2 = scene.tri_e2[idx]
            tangent = vec.normalize(
                e1 * duv2[..., 1:2] - e2 * duv1[..., 1:2]
            )
            bitangent = vec.normalize(
                e2 * duv1[..., 0:1] - e1 * duv2[..., 0:1]
            )
            # normal map: tangent-space RGB -> world
            ns = scene.textures.normal_sample(
                tri_mat_g.normal_texture, uv[..., 0], uv[..., 1]
            )
            tbn_n = vec.normalize(vec.cross(tangent, bitangent))
            mapped = vec.normalize(
                tangent * ns[..., 0:1]
                + bitangent * ns[..., 1:2]
                + tbn_n * ns[..., 2:3]
            )
            use_nmap = tri_mat_g.normal_texture >= 0
            n_obj = jnp.where(use_nmap[..., None], mapped, n_obj)
            # bump map: height-gradient perturbation
            bump = scene.textures.bump_sample(
                tri_mat_g.bump_texture, uv[..., 0], uv[..., 1]
            )
            bumped = vec.normalize(
                n_obj
                + tangent * (bump[..., 0:1] * tri_mat_g.bump_multiplier[..., None])
                + bitangent * (bump[..., 1:2] * tri_mat_g.bump_multiplier[..., None])
            )
            use_bump = tri_mat_g.bump_texture >= 0
            n_obj = jnp.where(use_bump[..., None], bumped, n_obj)

        inv = scene.inst_inv[inst]
        n = _xform_normal(inv, n_obj)
        sel(m, n, tm, uv[..., 0], uv[..., 1])

    for i, (sdf_obj, mid, _lo, _hi) in enumerate(scene.sdf_objects):
        m = (hit.ptype == PT_SDF) & (hit.pindex == i)
        n = sdf_mod.sdf_normal(sdf_obj, pos)
        sel(m, n, jnp.int32(mid))

    for i, vol in enumerate(scene.volumes):
        m = (hit.ptype == PT_VOLUME) & (hit.pindex == i)
        n = vol_mod.normal_at(scene.volume_data[i], vol, pos)
        vm = vol_mod.material_at(scene.volume_data[i], vol, pos)
        sel(m, n, vm)

    for i, (hf, mid) in enumerate(scene.functions):
        m = (hit.ptype == PT_FUNCTION) & (hit.pindex == i)
        n = fn_mod.normal_at(hf, pos)
        sel(m, n, jnp.int32(mid))

    # normal flip toward the ray + inside flag (Hit.cs:36-47); SDF and
    # volume shapes never report inside.
    facing = vec.dot(normal, dirn) > 0.0
    normal = jnp.where(facing[:, None], -normal, normal)
    no_inside = (hit.ptype == PT_SDF) | (hit.ptype == PT_VOLUME)
    inside = facing & ~no_inside & (hit.ptype != PT_NONE)

    return HitInfo(
        position=pos,
        normal=normal,
        inside=inside,
        mat_id=mat_id,
        tex_u=tex_u,
        tex_v=tex_v,
    )
