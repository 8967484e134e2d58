"""Analytic tape backward for the bounce chain (custom_vjp over the trace).

AD through the depth scan re-runs each bounce's traversal + shading + RNG
in the backward (remat) and then transposes it. But with geometry and
all discrete decisions detached, the radiance estimator is a PRODUCT
CHAIN in the differentiable scene parameters:

  L = sum_d [ miss_d  * T_d . env
            + emit_d  * T_d . c_d * e_d
            + nee_d   * (T_d . B_d) . C[lm_d] * e[lm_d] * kappa_d ]
  T_{d+1} = alive_d ? T_d . B_d * rr_d : T_d,
  B_d     = spec_d ? 1 + (c_d - 1) * tint : c_d        (naive mode: w = 1)

so the backward needs only a tiny per-depth tape (TapeRecord: throughput,
material id, uv, light material, kappa, RR scale, flag bits — ~10 scalars
per ray per depth) and a reverse scan whose body REBUILDS those pointwise
terms and jax.vjp's them locally: no traversal, no RNG, no sort, no
shading re-run. jax.vjp of the rebuild transposes the material-table and
texture-atlas gathers into scatter-adds for free.

Parameter contract (matches the tested gradient surface,
tests/test_diff.py + test_modes_and_passes.py): material color,
material emittance, material tint, light color/emittance (same table),
environment color, texture atlas texels. Parameters whose only gradient
path runs through sampled DIRECTIONS (gloss -> cone aperture, IOR ->
refraction direction/Fresnel weight) are intentionally dropped — the
naive-mode estimator's weight is 1, so these only reach the radiance via
bounce-direction perturbations that the primary AD path also treats as
near-detached. Use jax.grad through integrator.trace when those matter.

Scope: naive specular mode, single-light NEE modes (random/power).
trace_tape_radiance falls back to plain AD-able trace() otherwise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from dataclasses import replace

from ptsharp.integrator import (
    TAPE_ALIVE, TAPE_EMIT, TAPE_MISS_ENV, TAPE_NEE, TAPE_SPEC, TAPE_TEX,
    IntegratorConfig, RayState, SPECULAR_MODE_NAIVE, LIGHT_MODE_ALL,
    TapeRecord, _atlas_nontrivial, _step, trace,
)
from ptsharp.core import sampling
from ptsharp.scene import SceneData
from ptsharp.textures import TextureAtlas


class DiffParams(NamedTuple):
    """The differentiable scene-parameter leaves the tape backward covers."""

    color: jnp.ndarray      # (M, 3) material colors (also light colors)
    emittance: jnp.ndarray  # (M,)
    tint: jnp.ndarray       # (M,)
    env_color: jnp.ndarray  # (3,)
    tex_data: jnp.ndarray   # (K, H, W, 3) texture atlas


def _plug(scene: SceneData, p: DiffParams) -> SceneData:
    return replace(
        scene,
        materials=scene.materials._replace(
            color=p.color, emittance=p.emittance, tint=p.tint),
        env_color=p.env_color,
        textures=scene.textures._replace(data=p.tex_data),
    )


def tape_supported(scene: SceneData, cfg: IntegratorConfig) -> bool:
    return (cfg.specular_mode == SPECULAR_MODE_NAIVE
            and cfg.light_mode != LIGHT_MODE_ALL)


def _trace_tape(scene: SceneData, cfg: IntegratorConfig, org, dirn, key,
                strat_idx=None, n_strat: int = 1):
    """trace() for the naive mode, collecting a (D, R, ...) TapeRecord
    stack. The key chain is IDENTICAL to trace()'s (same _step, same
    fold_in chain), so the primal radiance is bit-equal to trace()."""
    r = org.shape[0]
    state = RayState(
        org=org, dirn=dirn,
        throughput=jnp.ones((r, 3), jnp.float32),
        radiance=jnp.zeros((r, 3), jnp.float32),
        emission_ok=jnp.ones(r, bool),
        alive=jnp.ones(r, bool),
    )
    rays = jnp.int32(0)
    k0, krest = jax.random.split(key)
    k0a, k0u, k0v = jax.random.split(k0, 3)
    ju = jax.random.uniform(k0u, (r,))
    jv = jax.random.uniform(k0v, (r,))
    if strat_idx is not None and n_strat > 1:
        u1, u2 = sampling.stratified_pair(ju, jv, n_strat, strat_idx)
    else:
        u1, u2 = ju, jv
    state, rays, alb, nrm, tape0 = _step(
        scene, cfg, state, rays, k0a, u1, u2, None, 0, want_tape=True)

    def scan_body(carry, depth):
        cur, rays_acc = carry
        dk = jax.random.fold_in(jax.random.fold_in(krest, 0), depth)
        ku_, kv_ = jax.random.split(jax.random.fold_in(dk, 7))
        uu = jax.random.uniform(ku_, (r,))
        vv = jax.random.uniform(kv_, (r,))
        cur, rays_acc, _, _, tp = _step(
            scene, cfg, cur, rays_acc, dk, uu, vv, None, depth,
            sort_rays=True, want_tape=True)
        return (cur, rays_acc), tp

    if cfg.max_bounces >= 1:
        (state, rays), tapes = jax.lax.scan(
            scan_body, (state, rays), jnp.arange(1, cfg.max_bounces + 1))
        tape = jax.tree.map(
            lambda a, b: jnp.concatenate([a[None], b]), tape0, tapes)
    else:
        tape = jax.tree.map(lambda a: a[None], tape0)
    return state.radiance, (alb, nrm, rays), tape


def _rebuild_terms_lanes(scene: SceneData, lanes, T, tp: TapeRecord):
    """Pointwise reconstruction of one depth's radiance terms and
    throughput update from PER-LANE gathered parameter values — the
    function whose local jax.vjp IS the analytic backward (module
    docstring equations; semantics from integrator._step). Taking the
    GATHERED values (not the tables) as inputs keeps the vjp dense
    elementwise; _tape_backward aggregates the per-lane cotangents into
    the tables with one-hot matmuls (_onehot_accum)."""
    cm, e, tint, cl, el, envc, tex = lanes
    c = cm
    if _atlas_nontrivial(scene):
        atlas = TextureAtlas(data=tex, sizes=scene.textures.sizes)
        tid = scene.materials.texture[tp.mat_id]
        c_tex = atlas.sample(tid, tp.uv[:, 0], tp.uv[:, 1])
        has_tex = (tp.flags & TAPE_TEX) != 0
        c = jnp.where(has_tex[:, None], c_tex, c)
    is_spec = (tp.flags & TAPE_SPEC) != 0
    one = jnp.ones_like(c)
    B = jnp.where(is_spec[:, None], one + (c - one) * tint[:, None], c)
    if scene.env_texture >= 0:
        atlas = TextureAtlas(data=tex, sizes=scene.textures.sizes)
        etid = jnp.full(tp.mat_id.shape, scene.env_texture, jnp.int32)
        env = atlas.sample(etid, tp.uv[:, 0], tp.uv[:, 1])
    else:
        env = jnp.broadcast_to(envc, c.shape)
    D = cl * (el * tp.kappa)[:, None]
    miss = ((tp.flags & TAPE_MISS_ENV) != 0)[:, None]
    emit = ((tp.flags & TAPE_EMIT) != 0)[:, None]
    nee = ((tp.flags & TAPE_NEE) != 0)[:, None]
    alive = ((tp.flags & TAPE_ALIVE) != 0)[:, None]
    terms = (
        jnp.where(miss, T * env, 0.0)
        + jnp.where(emit, T * c * e[:, None], 0.0)
        + jnp.where(nee, (T * B) * D, 0.0)
    )
    t_next = jnp.where(alive, T * B * tp.rr[:, None], T)
    return terms, t_next


def _onehot_accum(idx, m, cots):
    """Sum per-lane cotangents into an m-row table per index: one one-hot
    matmul instead of a scatter-add of 1M lanes into a few rows (which of
    the two is faster on the GPU is ROADMAP Queue 1 item 6). cots: list
    of (R,) or (R, 3) arrays -> list of (m,) / (m, 3). Falls back to
    scatter-add for large tables where the (R, m) one-hot would not
    pay."""
    if m > 512:
        outs = []
        for ct in cots:
            z = jnp.zeros((m,) + ct.shape[1:], ct.dtype)
            outs.append(z.at[idx].add(ct))
        return outs
    # ONE stacked matmul: (m, R) @ (R, sum_widths). bf16 one-hot (exact:
    # 0/1) halves the padded-lane traffic of the big operand.
    oh = (idx[:, None] == jnp.arange(m, dtype=idx.dtype)[None, :])
    oh = oh.astype(jnp.bfloat16)  # (R, m)
    cols = [ct[:, None] if ct.ndim == 1 else ct for ct in cots]
    widths = [c.shape[1] for c in cols]
    stacked = jnp.concatenate(cols, axis=1)  # (R, W)
    # HIGHEST: the f32 cotangents must not be rounded to TF32 on the GPU
    agg = jax.lax.dot_general(
        oh, stacked, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)  # (m, W)
    outs = []
    off = 0
    for ct, w in zip(cots, widths):
        sl = agg[:, off:off + w]
        outs.append(sl[:, 0] if ct.ndim == 1 else sl)
        off += w
    return outs


def _tape_backward(scene: SceneData, cfg: IntegratorConfig, p: DiffParams,
                   tape: TapeRecord, g):
    """Reverse scan over the tape: accumulates DiffParams cotangents and
    carries the throughput cotangent Ybar up the chain."""
    r = g.shape[0]
    m = p.color.shape[0]
    p0 = jax.tree.map(jnp.zeros_like, p)

    def body(carry, tp):
        ybar, acc = carry
        lanes = (p.color[tp.mat_id], p.emittance[tp.mat_id],
                 p.tint[tp.mat_id], p.color[tp.lm], p.emittance[tp.lm],
                 p.env_color, p.tex_data)
        (_terms, _tn), vjp_fn = jax.vjp(
            lambda ln, T: _rebuild_terms_lanes(scene, ln, T, tp),
            lanes, tp.t_in)
        (dcm, de, dtint, dcl, del_, denv, dtex), dT = vjp_fn((g, ybar))
        c_m, e_m, t_m = _onehot_accum(tp.mat_id, m, [dcm, de, dtint])
        c_l, e_l = _onehot_accum(tp.lm, m, [dcl, del_])
        acc = DiffParams(
            color=acc.color + c_m + c_l,
            emittance=acc.emittance + e_m + e_l,
            tint=acc.tint + t_m,
            env_color=acc.env_color + denv,
            tex_data=acc.tex_data + dtex,
        )
        return (dT, acc), None

    (_, pgrad), _ = jax.lax.scan(
        body, (jnp.zeros((r, 3), jnp.float32), p0), tape, reverse=True)
    return pgrad


class TapeResult(NamedTuple):
    radiance: jnp.ndarray
    albedo: jnp.ndarray
    normal: jnp.ndarray
    rays_traced: jnp.ndarray


def _zero_cot(x):
    if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.inexact):
        return jnp.zeros_like(x)
    return np.zeros(jnp.shape(x), jax.dtypes.float0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _radiance_cv(cfg, p, scene, org, dirn, key):
    scene2 = _plug(scene, p)
    res = trace(scene2, cfg, org, dirn, key)
    return res.radiance, res.albedo, res.normal, res.rays_traced


def _radiance_cv_fwd(cfg, p, scene, org, dirn, key):
    scene2 = _plug(scene, p)
    radiance, (alb, nrm, rays), tape = _trace_tape(
        scene2, cfg, org, dirn, key)
    return ((radiance, alb, nrm, rays),
            (p, scene, org, dirn, key, tape))


def _radiance_cv_bwd(cfg, resid, cots):
    p, scene, org, dirn, key, tape = resid
    g = cots[0]  # cotangent on radiance; aux outputs' cotangents unused
    scene2 = _plug(scene, p)
    pgrad = _tape_backward(scene2, cfg, p, tape, g)
    return (
        pgrad,
        jax.tree.map(_zero_cot, scene),
        _zero_cot(org),
        _zero_cot(dirn),
        _zero_cot(key),
    )


_radiance_cv.defvjp(_radiance_cv_fwd, _radiance_cv_bwd)


def trace_tape_radiance(scene: SceneData, cfg: IntegratorConfig,
                        org, dirn, key) -> TapeResult:
    """trace() with the analytic tape backward: same primal radiance
    (bit-identical key chain), gradients w.r.t. the DiffParams leaves via
    the custom_vjp (module docstring contract). Falls back to the plain
    AD-able trace() for unsupported configs."""
    if not tape_supported(scene, cfg):
        res = trace(scene, cfg, org, dirn, key)
        return TapeResult(res.radiance, res.albedo, res.normal,
                          res.rays_traced)
    p = DiffParams(
        color=scene.materials.color,
        emittance=scene.materials.emittance,
        tint=scene.materials.tint,
        env_color=scene.env_color,
        tex_data=scene.textures.data,
    )
    skel = _plug(scene, jax.tree.map(jax.lax.stop_gradient, p))
    radiance, alb, nrm, rays = _radiance_cv(cfg, p, skel, org, dirn, key)
    return TapeResult(radiance, alb, nrm, rays)
