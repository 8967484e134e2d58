"""Wavefront path integrator — the array-program replacement for the
reference's recursive megakernel (Sampler.cs:55-145).

Where the reference recurses per ray with branchy virtual dispatch, this
integrator advances a whole SoA wavefront one bounce at a time:

  depth 0   : stratified first-hit sampling (Sampler.cs:96-102), optional
              diffuse/specular branch split (SpecularModeFirst/All,
              Sampler.cs:85-94)
  per bounce: closest-hit -> masked branchless material sampling
              (Ray.Bounce, Ray.cs:44-85: Fresnel-probability choice of
              specular reflect / refract / cosine-diffuse) -> batched
              next-event estimation (Sampler.cs:212-296 coverage model) ->
              masked Russian-roulette termination
  scan      : bounces 1..max form a `lax.scan` over carried ray state

Radiance accumulates as throughput-weighted contributions, which makes the
whole estimator a pure differentiable function of the material table,
texture atlas, and emitter parameters; discrete sampling decisions
(branch coins, light picks, RR) are detached via stop_gradient so the
reparameterized gradient is well-defined.

Every random draw derives from one threefry key folded per bounce — renders
are bit-reproducible given (scene, config, key).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jax.ad_checkpoint import checkpoint_name

from ptsharp.core import sampling, vec
from ptsharp.intersect import (
    Hit, HitInfo, closest_hit, hit_info, light_hit_t, occlusion_query,
)
from ptsharp.scene import (
    PT_CUBE, PT_CYLINDER, PT_NONE, PT_SPHERE, PT_TRIANGLE, SceneData,
)

# light types whose own hit distance is analytic (enables the any-hit
# occlusion shadow path — a boolean early-exit query instead of a full
# closest-hit that must land on the light)
_ANALYTIC_LIGHT_TYPES = (PT_SPHERE, PT_CUBE, PT_CYLINDER, PT_TRIANGLE)

LIGHT_MODE_RANDOM = "random"  # one random light x nLights (Sampler.cs:205-209)
LIGHT_MODE_ALL = "all"  # average over all lights (Sampler.cs:198-204)
# one light picked proportional to emitted power (pmf precomputed at scene
# build) — same expectation as "all"/"random" but with per-bounce cost flat
# in light count AND variance concentrated on the bright lights; the
# scalable mode for reference-runway-class scenes (Example.cs:1028-1082)
LIGHT_MODE_POWER = "power"

SPECULAR_MODE_NAIVE = "naive"  # russian-roulette branch pick every bounce
SPECULAR_MODE_FIRST = "first"  # force both branches at the first hit
# force both branches for the first `all_split_depth` bounces (the
# reference's SpecularModeAll splits at *every* depth, Sampler.cs:85-94 —
# exponential; the wavefront version bounds the split depth and falls back
# to the weighted single-branch estimator below it, preserving the
# estimator's expectation)
SPECULAR_MODE_ALL = "all"


@dataclass(frozen=True)
class IntegratorConfig:
    max_bounces: int = 4
    direct_lighting: bool = True
    soft_shadows: bool = True
    light_mode: str = LIGHT_MODE_RANDOM
    specular_mode: str = SPECULAR_MODE_NAIVE
    all_split_depth: int = 2  # branch-split depth cap for SPECULAR_MODE_ALL
    russian_roulette: bool = False  # dead-by-default in the reference too
    rr_start_depth: int = 2
    rr_min_prob: float = 0.05
    # rematerialize each scanned bounce in the backward pass: instead of
    # saving every bounce's wavefront residuals (hit records, shading
    # inputs) across the depth scan, the backward re-runs the bounce.
    # Numerically exact; trades recompute for HBM residual traffic.
    remat: bool = True
    # "hits": save the per-bounce hit records (6 scalars/ray — tiny) as
    # named checkpoint residuals so the backward rematerializes shading
    # but NOT the closest-hit traversal; "full": save nothing, re-run
    # everything. "full" leaves the recompute schedule to XLA; "hits" is
    # meant for scenes where traversal dominates (large meshes). Which wins
    # on the GPU is not measured yet.
    remat_policy: str = "full"
    # sort each scanned bounce's wavefront by direction-octant + origin
    # Morton before closest-hit (results scattered back): bounce rays are
    # incoherent, and both the chunked XLA walks and the Pallas packet
    # kernels traverse coherent chunks several times faster than the
    # argsort costs. Primary rays (depth 0) are image-ordered already.
    sort_bounces: bool = True
    # NEE shadow rays on mesh scenes as boolean any-hit occlusion queries
    # (the early-exit kernel under "pallas") instead of closest-hit-must-be-the-
    # light. Identical estimator up to epsilon placement for point/sphere
    # class lights; for multi-triangle mesh lights it is the estimator-
    # consistent refinement (sampled-point visibility — see the note in
    # sample_lights). Requires every light's own hit distance to be
    # analytic (sphere/cube/cylinder primitives or sampled mesh
    # triangles) — auto-falls back otherwise.
    anyhit_shadows: bool = True

    def __post_init__(self):
        assert self.remat_policy in ("full", "hits"), self.remat_policy
        assert self.light_mode in (
            LIGHT_MODE_RANDOM, LIGHT_MODE_ALL, LIGHT_MODE_POWER
        ), self.light_mode
        assert self.specular_mode in (
            SPECULAR_MODE_NAIVE, SPECULAR_MODE_FIRST, SPECULAR_MODE_ALL
        ), self.specular_mode


class RayState(NamedTuple):
    org: jnp.ndarray  # (R, 3)
    dirn: jnp.ndarray  # (R, 3)
    throughput: jnp.ndarray  # (R, 3)
    radiance: jnp.ndarray  # (R, 3)
    emission_ok: jnp.ndarray  # (R,) bool — add emitter radiance on hit?
    alive: jnp.ndarray  # (R,) bool


class TraceResult(NamedTuple):
    radiance: jnp.ndarray  # (R, 3)
    albedo: jnp.ndarray  # (R, 3) first-hit material color (denoiser guide)
    normal: jnp.ndarray  # (R, 3) first-hit shading normal
    rays_traced: jnp.ndarray  # () int32 — parity with Scene.rays counter


# tape flag bits (TapeRecord.flags)
TAPE_MISS_ENV = 1   # lane adds throughput * env this depth
TAPE_EMIT = 2       # lane adds throughput * color * emittance
TAPE_NEE = 4        # lane adds (throughput*B) * direct
TAPE_SPEC = 8       # bounce took the specular branch (B = tint mix)
TAPE_TEX = 16       # resolved color came from the texture atlas
TAPE_ALIVE = 32     # lane survives into the next depth


class TapeRecord(NamedTuple):
    """Per-depth analytic-backward replay record (tape.py): everything
    needed to rebuild this depth's radiance terms and throughput update as
    a POINTWISE function of the differentiable scene parameters — no
    traversal, no RNG, no sort in the backward."""

    t_in: jnp.ndarray    # (R, 3) throughput entering the depth
    mat_id: jnp.ndarray  # (R,) i32 hit material
    uv: jnp.ndarray      # (R, 2) texture uv at the hit (env uv on miss)
    lm: jnp.ndarray      # (R,) i32 NEE light material id
    kappa: jnp.ndarray   # (R,) f32: direct = C[lm] * e[lm] * kappa
    rr: jnp.ndarray      # (R,) f32 RR survivor scale (1/prob; 1 if off)
    flags: jnp.ndarray   # (R,) i32 TAPE_* bits


def _atlas_nontrivial(scene: SceneData) -> bool:
    """Static: the texture atlas holds real texels (matches the gate in
    _resolve_color — a (1,1,1,3) empty atlas never samples)."""
    return bool(scene.textures.data.shape[1] > 1
                or scene.textures.data.shape[0] > 1)


def _resolve_color(scene: SceneData, mat, info: HitInfo):
    """Per-point textured albedo (Material.MaterialAt, Material.cs:124-138)."""
    color = mat.color
    has_tex = mat.texture >= 0
    if bool(scene.textures.data.shape[1] > 1) or scene.textures.data.shape[0] > 1:
        tex_c = scene.textures.sample(mat.texture, info.tex_u, info.tex_v)
        color = jnp.where(has_tex[:, None], tex_c, color)
    return color


def _resolve_gloss(scene: SceneData, mat, info: HitInfo):
    gloss = mat.gloss
    has_tex = mat.gloss_texture >= 0
    if bool(scene.textures.data.shape[1] > 1) or scene.textures.data.shape[0] > 1:
        tex_g = scene.textures.sample(mat.gloss_texture, info.tex_u, info.tex_v)
        gloss = jnp.where(has_tex, jnp.mean(tex_g, axis=-1), gloss)
    return gloss


def env_uv(scene: SceneData, dirn):
    """Lat-long env coordinates for a direction batch (textured env)."""
    d = dirn
    u = jnp.arctan2(d[..., 2], d[..., 0]) + scene.texture_angle
    v = jnp.arctan2(
        d[..., 1], jnp.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2)
    )
    u = (u + jnp.pi) / (2.0 * jnp.pi)
    v = (v + jnp.pi / 2.0) / jnp.pi
    return u, v


def sample_environment(scene: SceneData, dirn):
    """Panoramic lat-long environment or flat color
    (Sampler.sampleEnvironment, Sampler.cs:177-189)."""
    if scene.env_texture >= 0:
        u, v = env_uv(scene, dirn)
        tid = jnp.full(dirn.shape[:-1], scene.env_texture, jnp.int32)
        return scene.textures.sample(tid, u, v)
    return jnp.broadcast_to(scene.env_color, dirn.shape)


def sample_lights(scene: SceneData, cfg: IntegratorConfig, position, normal,
                  key, active=None, want_aux=False):
    """Batched NEE (Sampler.sampleLights/sampleLight, Sampler.cs:191-296).

    Returns the direct-light contribution BEFORE albedo weighting (the
    caller multiplies by material color * throughput). Visibility is a
    boolean any-hit occlusion query bounded by the light's analytic hit
    distance (fast path) or a full closest-hit that must land on the
    sampled light. Discrete light choice and disc points are detached
    from the gradient.

    active: optional (R,) bool — lanes that are False skip all shadow
    traversal work (their t bound collapses so every box test fails
    instantly); their returned contribution is garbage the caller masks.

    want_aux: additionally return the tape decomposition
    (lm_mat (R,) i32, kappa (R,) f32) with
    direct = materials.color[lm] * materials.emittance[lm] * kappa —
    the analytic-backward replay record (tape.py). Only single-light
    modes (random/power) decompose this way; "all" returns aux=None.
    """
    n_lights = scene.num_lights
    r = position.shape[0]
    if n_lights == 0 or not cfg.direct_lighting:
        if want_aux:
            return (jnp.zeros((r, 3), jnp.float32), jnp.int32(0),
                    (jnp.zeros(r, jnp.int32), jnp.zeros(r, jnp.float32)))
        return jnp.zeros((r, 3), jnp.float32), jnp.int32(0)
    if active is None:
        active = jnp.ones(r, bool)

    has_em = scene.em_v0.shape[0] > 0  # static: any per-triangle lights

    def one_light(lidx, key):
        """lidx (R,) int32 per-ray light index."""
        center = scene.light_center[lidx]
        radius = scene.light_radius[lidx]
        is_tri = scene.light_ptype[lidx] == PT_TRIANGLE
        k1, k2, k3 = jax.random.split(key, 3)
        if cfg.soft_shadows:
            u1 = jax.random.uniform(k1, (r,))
            u2 = jax.random.uniform(k2, (r,))
            dx, dy = sampling.uniform_disc_area(u1, u2)
            l = vec.normalize(center - position)
            t_ax, b_ax = vec.orthonormal_basis(l)
            point = (
                center
                + t_ax * (dx * radius)[:, None]
                + b_ax * (dy * radius)[:, None]
            )
        else:
            u1 = jax.random.uniform(k1, (r,))
            u2 = jax.random.uniform(k2, (r,))
            point = center

        # --- per-triangle area sampling for mesh lights --------------------
        # (replaces the reference's bounding-disc proxy for emissive meshes;
        # standard one-sample area NEE with pdf = 1/total_area)
        if has_em:
            n_em = scene.em_v0.shape[0]
            uc = jax.random.uniform(k3, (r,))
            start = scene.light_tri_start[lidx]
            end = scene.light_tri_end[lidx]
            lo = start
            hi = jnp.maximum(end - 1, start)

            def bs_step(_i, lohi):
                blo, bhi = lohi
                mid = (blo + bhi) // 2
                cm = scene.em_cdf[jnp.clip(mid, 0, n_em - 1)]
                go_hi = cm < uc
                return (jnp.where(go_hi, mid + 1, blo),
                        jnp.where(go_hi, bhi, mid))

            lo, hi = jax.lax.fori_loop(0, 21, bs_step, (lo, hi))
            tri = jnp.clip(lo, start, jnp.maximum(end - 1, 0))
            su = jnp.sqrt(u1)
            b1 = su * (1.0 - u2)
            b2 = su * u2
            p_tri = (
                scene.em_v0[tri]
                + scene.em_e1[tri] * b1[:, None]
                + scene.em_e2[tri] * b2[:, None]
            )
            point = jnp.where(is_tri[:, None], p_tri, point)

        point = jax.lax.stop_gradient(point)
        ray_dir = vec.normalize(point - position)
        cos_t = vec.dot(ray_dir, normal)
        facing = cos_t > 0.0

        use_anyhit = (
            cfg.anyhit_shadows
            and len(scene.light_types) > 0
            and all(t in _ANALYTIC_LIGHT_TYPES for t in scene.light_types)
        )
        if use_anyhit:
            # visibility = "the ray reaches the light's own surface": its
            # analytic hit distance t_light (INF = grazing miss), minus a
            # margin so the light never self-occludes, bounds a boolean
            # any-hit query (Sampler.cs:261-265 semantics; the early-exit
            # kernel makes shadow traversal much cheaper than closest-hit).
            # For multi-triangle mesh lights this is the estimator-
            # CONSISTENT visibility: a closer emissive triangle of the
            # same light OCCLUDES the sampled point (the area-CDF pdf is
            # for THAT point), where the fallback path below — matching
            # the reference — counts any emissive hit on the light
            # instance as visible and slightly over-counts concave
            # emitters. Flagged semantic upgrade, not drift.
            t_light = light_hit_t(scene, position, ray_dir, lidx)
            if PT_TRIANGLE in scene.light_types:
                t_light = jnp.where(
                    is_tri, vec.length(point - position), t_light
                )
            t_hit = t_light < vec.INF
            t_cut = t_light * (1.0 - 1e-3) - 1e-3
            # lanes that face away, miss the light, or are dead skip all
            # traversal (their bound fails every box test instantly)
            t_cut = jnp.where(facing & t_hit & active, t_cut, -vec.INF)
            if cfg.sort_bounces and scene.inst_inv.shape[0] > 0:
                occ = _sorted_occlusion(scene, position, ray_dir, t_cut)
            else:
                occ = occlusion_query(scene, position, ray_dir, t_cut)
            occ = checkpoint_name(occ, "hit")
            visible = t_hit & ~occ
        else:
            # bound the shadow search at the light: traversal prunes
            # everything behind it (the light itself must still register,
            # hence the slack)
            hyp0 = vec.length(center - position)
            shadow_tmax = jnp.where(
                is_tri,
                vec.length(point - position) * 1.001 + 1e-3,
                hyp0 + 2.0 * radius + 1e-3,
            )
            shadow_tmax = jnp.where(active, shadow_tmax, -vec.INF)
            # shadow rays sort like bounce rays (mesh scenes): origins are
            # scattered surface points, directions cluster toward the light
            if cfg.sort_bounces and scene.inst_inv.shape[0] > 0:
                shadow_hit = _sorted_closest_hit(scene, position, ray_dir,
                                                 t_max=shadow_tmax)
            else:
                shadow_hit = closest_hit(scene, position, ray_dir,
                                         t_max=shadow_tmax)
            shadow_hit = Hit(*(checkpoint_name(f, "hit")
                               for f in shadow_hit))
            idx_match = jnp.where(
                is_tri,
                shadow_hit.inst == scene.light_pindex[lidx],
                shadow_hit.pindex == scene.light_pindex[lidx],
            )
            if has_em:
                # per-tri Ke meshes: the shadow ray must land on an
                # *emissive* triangle of the light instance, not just any
                # of its triangles
                hp = jnp.maximum(shadow_hit.pindex, 0)
                hover = scene.inst_mat[jnp.maximum(shadow_hit.inst, 0)]
                htm = jnp.where(hover >= 0, hover, scene.tri_mat[hp])
                hit_emissive = scene.materials.emittance[htm] > 0.0
                idx_match = idx_match & (~is_tri | hit_emissive)
            visible = (
                (shadow_hit.ptype == scene.light_ptype[lidx])
                & idx_match
                & (shadow_hit.t < vec.INF)
            )

        # solid-angle "coverage" ~ r^2/d^2 capped at 1 (Sampler.cs:277-289;
        # the asin/tan chain there reduces to R^2/(h^2 - R^2)).
        hyp = vec.length(center - position)
        cov = (radius * radius) / jnp.maximum(hyp * hyp - radius * radius, 1e-12)
        cov = jnp.where(hyp < radius, 1.0, jnp.minimum(cov, 1.0))

        lmat = scene.materials.gather(scene.light_mat[lidx])
        scale = lmat.emittance * cos_t * cov
        contrib = lmat.color * scale[:, None]
        lm = scene.light_mat[lidx]
        kap = cos_t * cov
        if has_em:
            emat = scene.materials.gather(scene.em_mat[tri])
            d2 = jnp.sum((point - position) ** 2, axis=-1)
            cos_l = jnp.abs(vec.dot(scene.em_nrm[tri], ray_dir))
            kap_tri = (
                cos_t * cos_l * scene.light_area[lidx]
                / jnp.maximum(d2, 1e-8)
            )
            scale_tri = emat.emittance * kap_tri
            contrib = jnp.where(
                is_tri[:, None], emat.color * scale_tri[:, None], contrib
            )
            lm = jnp.where(is_tri, scene.em_mat[tri], lm)
            kap = jnp.where(is_tri, kap_tri, kap)
        ok = facing & visible
        aux = (lm.astype(jnp.int32),
               jax.lax.stop_gradient(jnp.where(ok, kap, 0.0)))
        return jnp.where(ok[:, None], contrib, 0.0), aux

    if cfg.light_mode == LIGHT_MODE_ALL:
        total = jnp.zeros((r, 3), jnp.float32)
        keys = jax.random.split(key, n_lights)
        for li in range(n_lights):
            c, _aux = one_light(jnp.full(r, li, jnp.int32), keys[li])
            total = total + c
        if want_aux:
            return total / n_lights, jnp.int32(n_lights * r), None
        return total / n_lights, jnp.int32(n_lights * r)
    elif cfg.light_mode == LIGHT_MODE_POWER:
        kpick, ksmp = jax.random.split(key)
        u = jax.random.uniform(kpick, (r,))
        lidx = jnp.clip(
            jnp.searchsorted(scene.light_cdf, u, side="right"),
            0, n_lights - 1,
        ).astype(jnp.int32)
        lidx = jax.lax.stop_gradient(lidx)
        inv_pdf = 1.0 / jnp.maximum(scene.light_pmf[lidx], 1e-12)
        inv_pdf = jax.lax.stop_gradient(inv_pdf)
        c, (lm, kap) = one_light(lidx, ksmp)
        if want_aux:
            return c * inv_pdf[:, None], jnp.int32(r), (lm, kap * inv_pdf)
        return c * inv_pdf[:, None], jnp.int32(r)
    else:
        kpick, ksmp = jax.random.split(key)
        lidx = jax.random.randint(kpick, (r,), 0, n_lights)
        lidx = jax.lax.stop_gradient(lidx)
        c, (lm, kap) = one_light(lidx, ksmp)
        if want_aux:
            return (c * float(n_lights), jnp.int32(r),
                    (lm, kap * float(n_lights)))
        return c * float(n_lights), jnp.int32(r)


def _bounce(scene: SceneData, cfg: IntegratorConfig, state: RayState,
            info: HitInfo, mat, color, gloss, key, u1, u2,
            force_mode: str | None = None):
    """One material-sampling event over the wavefront (Ray.Bounce,
    Ray.cs:44-85). u1/u2 are the (possibly stratified) primary draws.

    force_mode: None = BounceTypeAny coin flip; "diffuse"/"specular" force
    the branch and return the branch probability as a weight (the
    SpecularModeFirst split, Sampler.cs:85-131).

    Returns (new_org, new_dirn, branch_weight(R,3), is_specular(R,),
    p_weight(R,)).
    """
    n = info.normal
    d = state.dirn
    n1 = jnp.where(info.inside, mat.index, 1.0)
    n2 = jnp.where(info.inside, 1.0, mat.index)
    fresnel = vec.reflectance(n, d, n1, n2)
    p = jnp.where(mat.reflectivity >= 0.0, mat.reflectivity, fresnel)
    p = jnp.clip(p, 0.0, 1.0)

    kcoin, kcone = jax.random.split(key)
    if force_mode is None:
        coin = jax.random.uniform(kcoin, p.shape)
        reflect_branch = jax.lax.stop_gradient(coin < p)
        weight = jnp.ones_like(p)  # BounceTypeAny sets p = 1 (Sampler.cs:104-107)
    elif force_mode == "specular":
        reflect_branch = jnp.ones(p.shape, bool)
        weight = p
    else:  # diffuse (the non-reflect branch; includes refraction weight 1-p)
        reflect_branch = jnp.zeros(p.shape, bool)
        weight = 1.0 - p

    ku, kv = jax.random.split(kcone)
    cu = jax.random.uniform(ku, p.shape)
    cv = jax.random.uniform(kv, p.shape)

    # specular: mirror + gloss cone (Ray.cs:73)
    spec_dir = sampling.cone(vec.normalize(vec.reflect(n, d)), gloss, cu, cv)
    # refraction (Ray.cs:75-79): offset origin, gloss cone
    refr_raw = vec.refract(n, d, n1, n2)
    tir = vec.dot(refr_raw, refr_raw) < 1e-12
    refr_dir = sampling.cone(vec.normalize(refr_raw), gloss, cu, cv)
    # diffuse: cosine hemisphere around the shading normal (Ray.cs:28-35)
    diff_dir = sampling.cosine_hemisphere(n, u1, u2)

    transparent = mat.transparent & ~reflect_branch
    # TIR in the transparent branch produces a zero direction in the
    # reference (killing the path via zero contribution); we reflect instead,
    # which conserves energy. Semantically a strict upgrade flagged here.
    transparent_dir = jnp.where(tir[:, None], spec_dir, refr_dir)

    new_dir = jnp.where(
        reflect_branch[:, None],
        spec_dir,
        jnp.where(transparent[:, None], transparent_dir, diff_dir),
    )
    is_specular = reflect_branch | transparent  # both return reflected=true

    # throughput factors: specular/refract tinted by Mix(1, color, tint)
    # (Sampler.cs:111-114); diffuse multiplies albedo (Sampler.cs:123-127)
    one = jnp.ones_like(color)
    tinted = one + (color - one) * mat.tint[:, None]
    branch_color = jnp.where(is_specular[:, None], tinted, color)
    branch_weight = branch_color * weight[:, None]

    # offset along the new direction (reference offsets refracted rays by
    # 1e-4, Ray.cs:77; doing it for every branch avoids fp32 self-hits)
    new_org = info.position + new_dir * 1e-4
    return new_org, new_dir, branch_weight, is_specular, p


def _remat_policy(cfg: IntegratorConfig):
    """Checkpoint policy for the per-bounce remat: "hits" keeps the named
    hit-record residuals (cheap) so the backward skips the traversal."""
    if cfg.remat_policy == "hits":
        return jax.checkpoint_policies.save_only_these_names("hit")
    return None


def _sorted_closest_hit(scene: SceneData, org, dirn, t_max=None):
    """Closest-hit with the wavefront permuted into Morton/octant order so
    traversal chunks are coherent; the hit record is scattered back to the
    caller's lane order. Pure detached permutation — estimator unchanged."""
    mk = _morton_key(org, dirn)
    perm = jnp.argsort(mk)
    tm = None
    if t_max is not None:
        tm = jnp.broadcast_to(
            jax.lax.stop_gradient(jnp.asarray(t_max, jnp.float32)),
            (org.shape[0],)
        )[perm]
    hit = closest_hit(scene, org[perm], dirn[perm], t_max=tm)
    inv = _inverse_perm(perm)
    return Hit(*(f[inv] for f in hit))


def _inverse_perm(perm):
    """O(n) scatter inverse of a permutation (an argsort(perm) would be a
    second full sort per bounce)."""
    n = perm.shape[0]
    return jnp.zeros(n, perm.dtype).at[perm].set(
        jnp.arange(n, dtype=perm.dtype))


def _sorted_occlusion(scene: SceneData, org, dirn, t_cut):
    """occlusion_query with the wavefront permuted into Morton/octant order
    (same coherence win as _sorted_closest_hit, boolean result)."""
    mk = _morton_key(org, dirn)
    perm = jnp.argsort(mk)
    occ = occlusion_query(scene, org[perm], dirn[perm], t_cut[perm])
    return occ[_inverse_perm(perm)]


def _step(scene: SceneData, cfg: IntegratorConfig, state, rays, depth_key,
          u1, u2, force_mode, depth_static,
          pre_hit=None, count_primary=True, suppress_shared=False,
          sort_rays=False, want_tape=False):
    """One wavefront bounce. Returns (state, rays, first_albedo,
    first_normal). pre_hit lets a branch split share one primary
    closest-hit between its two branches (Sampler.cs:85-131 re-traces;
    we don't). suppress_shared: this is the second wavefront of a
    branch split — env/emissive contributions at THIS hit were already
    accumulated by the first wavefront, so only the continuation may
    add radiance (the caller also zeroes the inherited radiance so the
    final sum over wavefronts counts everything exactly once)."""
    # static gate: sorting only pays where traversal is divergence-bound
    # (mesh scenes); analytic-only scenes would pay the argsort for nothing
    do_sort = sort_rays and cfg.sort_bounces and scene.inst_inv.shape[0] > 0
    # dead lanes (env miss, emissive cut) carry a collapsed t bound so
    # traversal retires them instantly instead of re-walking stale rays
    # every remaining depth (depth 0 is all-alive; the where is free)
    lane_tmax = jnp.where(state.alive, vec.INF, -vec.INF)
    if pre_hit is not None:
        hit = pre_hit
    elif do_sort:
        hit = _sorted_closest_hit(scene, state.org, state.dirn,
                                  t_max=lane_tmax)
    else:
        hit = closest_hit(scene, state.org, state.dirn, t_max=lane_tmax)
    # named residual: under remat_policy="hits" the backward pass keeps
    # these 6 per-ray scalars instead of re-running the traversal
    hit = Hit(*(checkpoint_name(f, "hit") for f in hit))
    if count_primary:
        rays = rays + jnp.sum(state.alive.astype(jnp.int32))
    info = hit_info(scene, state.org, state.dirn, hit)
    mat = scene.materials.gather(info.mat_id)
    color = _resolve_color(scene, mat, info)
    gloss = _resolve_gloss(scene, mat, info)

    missed = hit.ptype == PT_NONE
    env = sample_environment(scene, state.dirn)
    shared_on = jnp.asarray(not suppress_shared)
    radiance = state.radiance + jnp.where(
        (state.alive & missed & shared_on)[:, None],
        state.throughput * env, 0.0,
    )
    alive = state.alive & ~missed

    # emissive hit (Sampler.cs:73-80): suppressed emission kills the
    # path with zero contribution; allowed emission accumulates and the
    # path keeps scattering like the reference.
    # without NEE every path carries emission (the reference's
    # `!DirectLighting || emission` guard, Sampler.cs:73-80); with NEE
    # only specular-continued paths may add it (no double counting)
    emissive = mat.emittance > 0.0
    emission_allowed = (
        state.emission_ok if cfg.direct_lighting
        else jnp.ones_like(state.emission_ok)
    )
    emit_add = (alive & emissive & emission_allowed & shared_on)
    radiance = radiance + jnp.where(
        emit_add[:, None],
        state.throughput * color * mat.emittance[:, None],
        0.0,
    )
    if cfg.direct_lighting:
        alive = alive & ~(emissive & ~state.emission_ok)

    kb, kn, krr = jax.random.split(depth_key, 3)
    new_org, new_dir, branch_w, is_spec, _p = _bounce(
        scene, cfg, state, info, mat, color, gloss, kb, u1, u2, force_mode
    )

    throughput = state.throughput * branch_w

    # NEE on the diffuse branch (Sampler.cs:123-127): the contribution
    # is albedo * direct, i.e. post-branch throughput * direct.
    nee_mask = jnp.zeros_like(alive)
    nee_aux = None
    if cfg.direct_lighting and scene.num_lights > 0:
        nee_active = alive & ~is_spec
        direct, srays, nee_aux = sample_lights(
            scene, cfg, info.position, info.normal, kn, active=nee_active,
            want_aux=True,
        )
        nee_mask = nee_active
        radiance = radiance + jnp.where(
            nee_mask[:, None], throughput * direct, 0.0
        )
        rays = rays + jnp.sum(nee_mask.astype(jnp.int32))

    emission_ok = is_spec

    # Russian roulette (first-class masked termination; the reference's
    # version is dead code, Sampler.cs:133-142). depth_static may be a
    # traced scalar inside the depth scan, so the start-depth gate is a
    # where, not a Python branch.
    rr_scale = jnp.ones_like(u1)
    if cfg.russian_roulette:
        gate = jnp.asarray(depth_static) >= cfg.rr_start_depth
        prob = jnp.clip(
            jnp.max(jax.lax.stop_gradient(throughput), axis=-1),
            cfg.rr_min_prob,
            1.0,
        )
        prob = jnp.where(gate, prob, 1.0)
        u = jax.random.uniform(krr, prob.shape)
        survive = u < prob
        throughput = jnp.where(
            survive[:, None], throughput / prob[:, None], throughput
        )
        alive = alive & survive
        rr_scale = 1.0 / prob

    new_state = RayState(
        org=jnp.where(alive[:, None], new_org, state.org),
        dirn=jnp.where(alive[:, None], new_dir, state.dirn),
        throughput=jnp.where(alive[:, None], throughput, state.throughput),
        radiance=radiance,
        emission_ok=jnp.where(alive, emission_ok, state.emission_ok),
        alive=alive,
    )
    first_albedo = color
    first_normal = info.normal
    if want_tape:
        assert force_mode is None and not suppress_shared
        miss_env = state.alive & missed
        has_tex = (mat.texture >= 0) & _atlas_nontrivial(scene)
        uv = jnp.stack([info.tex_u, info.tex_v], axis=-1)
        if scene.env_texture >= 0:
            eu, ev = env_uv(scene, state.dirn)
            uv = jnp.where(miss_env[:, None],
                           jnp.stack([eu, ev], axis=-1), uv)
        if nee_aux is not None:
            lm, kappa = nee_aux
        else:
            lm = jnp.zeros_like(info.mat_id)
            kappa = jnp.zeros_like(u1)
        flags = (
            miss_env.astype(jnp.int32) * TAPE_MISS_ENV
            | emit_add.astype(jnp.int32) * TAPE_EMIT
            | nee_mask.astype(jnp.int32) * TAPE_NEE
            | is_spec.astype(jnp.int32) * TAPE_SPEC
            | has_tex.astype(jnp.int32) * TAPE_TEX
            | alive.astype(jnp.int32) * TAPE_ALIVE
        )
        tape = TapeRecord(
            t_in=jax.lax.stop_gradient(state.throughput),
            mat_id=info.mat_id,
            uv=jax.lax.stop_gradient(uv),
            lm=lm, kappa=kappa,
            rr=jax.lax.stop_gradient(rr_scale),
            flags=flags,
        )
        return new_state, rays, first_albedo, first_normal, tape
    return new_state, rays, first_albedo, first_normal



def trace(
    scene: SceneData,
    cfg: IntegratorConfig,
    org,
    dirn,
    key,
    strat_idx=None,
    n_strat: int = 1,
):
    """Trace a wavefront of R primary rays to completion.

    strat_idx: optional (R,) int32 sample index in [0, n_strat^2) driving
    stratified first-hit sampling (Sampler.cs:96-102). Returns TraceResult.
    """
    r = org.shape[0]
    state = RayState(
        org=org,
        dirn=dirn,
        throughput=jnp.ones((r, 3), jnp.float32),
        radiance=jnp.zeros((r, 3), jnp.float32),
        emission_ok=jnp.ones(r, bool),
        alive=jnp.ones(r, bool),
    )
    rays = jnp.int32(0)

    def step(*a, **kw):
        return _step(scene, cfg, *a, **kw)


    # ---- depth 0: stratified draws + optional branch split ---------------
    k0, krest = jax.random.split(key)
    k0a, k0u, k0v = jax.random.split(k0, 3)
    ju = jax.random.uniform(k0u, (r,))
    jv = jax.random.uniform(k0v, (r,))
    if strat_idx is not None and n_strat > 1:
        u1, u2 = sampling.stratified_pair(ju, jv, n_strat, strat_idx)
    else:
        u1, u2 = ju, jv

    # number of depths that force BOTH branches (wavefront doubles each):
    # first = 1, all = all_split_depth (bounded), naive = 0
    if cfg.specular_mode == SPECULAR_MODE_FIRST:
        n_split = 1
    elif cfg.specular_mode == SPECULAR_MODE_ALL:
        n_split = max(1, min(cfg.all_split_depth, cfg.max_bounces + 1))
    else:
        n_split = 0

    alb = nrm = None
    if n_split == 0:
        sa, rays, alb, nrm = step(state, rays, k0a, u1, u2, None, 0)
        states = [sa]
    else:
        states = [state]
        for d in range(n_split):
            new_states = []
            for si, st in enumerate(states):
                dk = jax.random.fold_in(jax.random.fold_in(k0a, d * 131), si)
                if d == 0:
                    uu, vv = u1, u2
                else:
                    ku_, kv_ = jax.random.split(jax.random.fold_in(dk, 7))
                    uu = jax.random.uniform(ku_, (r,))
                    vv = jax.random.uniform(kv_, (r,))
                # one shared closest-hit feeds both branches (the reference
                # re-traces, Sampler.cs:85-131; we don't)
                hit0 = closest_hit(scene, st.org, st.dirn)
                s_d, rays, a_, n_ = step(st, rays, dk, uu, vv, "diffuse", d,
                                         pre_hit=hit0)
                # second wavefront: zero inherited radiance + suppress the
                # shared env/emissive adds so the final sum over wavefronts
                # counts each contribution exactly once
                st_z = st._replace(radiance=jnp.zeros_like(st.radiance))
                s_s, rays, _, _ = step(st_z, rays, jax.random.fold_in(dk, 1),
                                       uu, vv, "specular", d, pre_hit=hit0,
                                       count_primary=False,
                                       suppress_shared=True)
                if d == 0 and si == 0:
                    alb, nrm = a_, n_
                new_states += [s_d, s_s]
            states = new_states

    # ---- remaining bounces: the shared depth scan (_trace_span) -----------
    # One traced body for every depth keeps the XLA graph (and compile
    # time) independent of max_bounces — the scanned-depth design of
    # SURVEY.md §5's "long-context equivalent". RR's depth gate becomes a
    # traced comparison inside the body. trace(), the compacted prefix
    # (_trace_prefix) and the compacted tail (_static_tail) all run THIS
    # ONE implementation, so the bit-identical key-chain invariant between
    # plain and compacted traces is structural, not a convention.
    results = []
    start_depth = max(n_split, 1) if n_split else 1
    for si, st in enumerate(states):
        cur, rays = _trace_span(scene, cfg, st, rays, krest,
                                start_depth, cfg.max_bounces + 1, si=si)
        results.append(cur.radiance)

    radiance = results[0]
    for extra in results[1:]:
        radiance = radiance + extra
    return TraceResult(
        radiance=radiance,
        albedo=alb,
        normal=nrm,
        rays_traced=rays,
    )


# ---------------------------------------------------------------------------
# On-device wavefront compaction (the replacement BASELINE names for the
# reference's WorkStealingScheduler.cs:9-30 dynamic load balancing):
# Russian roulette kills most lanes by mid-depth; instead of dragging dead
# lanes through every remaining bounce, the renderer syncs the live count
# once, sorts survivors to a dense prefix ON DEVICE, and finishes the tail
# depths on a power-of-two-bucketed buffer (so jit caches stay warm).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "n_strat", "d_stop"))
def _trace_prefix(scene, cfg: IntegratorConfig, org, dirn, key, strat_idx,
                  n_strat, d_stop: int):
    """Depths [0, d_stop) for the naive specular mode. Returns the carried
    state plus depth-0 AOVs."""
    r = org.shape[0]
    state = RayState(
        org=org,
        dirn=dirn,
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
    state, rays, alb, nrm = _step(scene, cfg, state, rays, k0a, u1, u2,
                                  None, 0)
    state, rays = _trace_span(scene, cfg, state, rays, krest, 1, d_stop)
    return state, rays, alb, nrm, krest


def _trace_span(scene, cfg: IntegratorConfig, state, rays, krest,
                d0: int, d1: int, si: int = 0):
    """THE depth scan: lax.scan of _step over depths [d0, d1). Every trace
    variant (plain, branch-split wavefront si, compacted prefix, compacted
    tail) runs this one body with the one key chain
    fold_in(fold_in(krest, si*1024), depth), so bit-identical random
    decisions across variants are guaranteed by construction."""
    if d1 <= d0:
        return state, rays
    r = state.org.shape[0]

    def span_step(scn, cur, rays_acc, dk, uu, vv, depth):
        cur, rays_acc, _, _ = _step(scn, cfg, cur, rays_acc, dk, uu, vv,
                                    None, depth, sort_rays=True)
        return cur, rays_acc

    if cfg.remat:
        span_step = jax.checkpoint(span_step, policy=_remat_policy(cfg))

    def scan_body(carry, depth):
        cur, rays_acc = carry
        dk = jax.random.fold_in(jax.random.fold_in(krest, si * 1024), depth)
        ku_, kv_ = jax.random.split(jax.random.fold_in(dk, 7))
        uu = jax.random.uniform(ku_, (r,))
        vv = jax.random.uniform(kv_, (r,))
        cur, rays_acc = span_step(scene, cur, rays_acc, dk, uu, vv, depth)
        return (cur, rays_acc), None

    (state, rays), _ = jax.lax.scan(
        scan_body, (state, rays), jnp.arange(d0, d1)
    )
    return state, rays


_trace_span_jit = functools.partial(jax.jit, static_argnames=("cfg", "d0", "d1"))(
    _trace_span
)


def _compact_state(state: RayState, cap: int):
    """Sort survivors to a dense prefix and take the first `cap` lanes.
    Returns (small_state_with_zero_radiance, src_indices)."""
    order = jnp.argsort(jnp.logical_not(state.alive), stable=True)
    src = order[:cap]
    small = RayState(
        org=state.org[src],
        dirn=state.dirn[src],
        throughput=state.throughput[src],
        radiance=jnp.zeros((cap, 3), jnp.float32),
        emission_ok=state.emission_ok[src],
        alive=state.alive[src],
    )
    return small, src


@functools.partial(jax.jit, static_argnames=("cfg", "cap", "d0", "d1"))
def _compact_and_finish(scene, cfg: IntegratorConfig, state: RayState,
                        krest, cap: int, d0: int, d1: int):
    """One post-sync program: on-device compaction, tail depths at the
    reduced width, scatter-add back, as a single dispatch."""
    small, src = _compact_state(state, cap)
    rays = jnp.int32(0)
    small, rays = _trace_span(scene, cfg, small, rays, krest, d0, d1)
    radiance = state.radiance.at[src].add(small.radiance)
    return radiance, rays


def _morton_key(p, d):
    """(R,) uint32 coherence key: [27:30] 3-bit direction octant | [0:27]
    origin Morton code
    over the batch's bounding box. Used to pack surviving bounce rays so
    chunked traversal sees spatially/directionally coherent chunks."""
    p = jax.lax.stop_gradient(p)
    lo = jnp.min(p, axis=0)
    hi = jnp.max(p, axis=0)
    q = jnp.clip((p - lo) / jnp.maximum(hi - lo, 1e-9), 0.0, 1.0)

    def expand(x):
        v = (x * 511.0).astype(jnp.uint32)  # 9 bits per axis
        v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
        v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
        v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
        v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
        return v

    m = (expand(q[..., 0]) << 2) | (expand(q[..., 1]) << 1) | expand(q[..., 2])
    octant = (
        (d[..., 0] > 0).astype(jnp.uint32)
        | ((d[..., 1] > 0).astype(jnp.uint32) << 1)
        | ((d[..., 2] > 0).astype(jnp.uint32) << 2)
    )
    return (octant << 27) | m


def _reservoir_compact(state: RayState, cap: int, key):
    """Shrink the wavefront to `cap` lanes with NO host sync and NO bias:
    if S = #alive exceeds cap, a uniform-random subset of cap lanes
    survives and each survivor's throughput is reweighted by S/cap —
    population control with exactly preserved expectation (each alive lane
    contributes E[kept] * S/cap = its original weight). When S <= cap every
    alive lane is kept unweighted and the tail is exact.

    Kept lanes are packed to the front ordered by the Morton/octant key,
    so the compacted buffer is also coherence-sorted for traversal (one
    argsort does both). Returns (small_state, src)."""
    alive = state.alive
    r = alive.shape[0]
    s_cnt = jnp.sum(alive.astype(jnp.int32))
    u = jax.random.uniform(key, (r,))
    order = jnp.argsort(jnp.where(alive, u, 2.0))
    rank = jnp.zeros(r, jnp.int32).at[order].set(
        jnp.arange(r, dtype=jnp.int32))
    keep = alive & (rank < cap)
    over = s_cnt > cap
    w = jnp.where(over, s_cnt.astype(jnp.float32) / cap, 1.0)
    w = jax.lax.stop_gradient(w)
    throughput = jnp.where(keep[:, None], state.throughput * w,
                           state.throughput)
    mk = _morton_key(state.org, state.dirn)
    pack = jnp.where(keep, mk, jnp.uint32(0xFFFFFFFF))
    src = jnp.argsort(pack)[:cap]
    small = RayState(
        org=state.org[src],
        dirn=state.dirn[src],
        throughput=throughput[src],
        radiance=jnp.zeros((cap, 3), jnp.float32),
        emission_ok=state.emission_ok[src],
        alive=keep[src],
    )
    return small, src


@functools.partial(jax.jit, static_argnames=("cfg", "schedule", "d_max"))
def _static_tail(scene, cfg: IntegratorConfig, state: RayState, krest,
                 schedule, d_max: int):
    """Depths [schedule[0].d, d_max) with reservoir compaction at each
    scheduled (depth, cap) — one program, zero host syncs. Radiance
    accumulated in each smaller buffer is scatter-added back up the chain."""
    rays = jnp.int32(0)
    stack = []
    cur = state
    for i, (d, cap) in enumerate(schedule):
        ck = jax.random.fold_in(krest, 70000 + 131 * d)
        small, src = _reservoir_compact(cur, cap, ck)
        stack.append((cur.radiance, src))
        d_next = schedule[i + 1][0] if i + 1 < len(schedule) else d_max
        small, rays = _trace_span(scene, cfg, small, rays, krest, d, d_next)
        cur = small
    rad = cur.radiance
    for parent_rad, src in reversed(stack):
        rad = parent_rad.at[src].add(rad)
    return rad, rays


def compaction_schedule(cfg: IntegratorConfig, r: int,
                        schedule: tuple | None = None,
                        min_cap: int = 1 << 12) -> tuple:
    """The static (depth, cap) reservoir schedule trace_compacted_static
    will use for an r-ray wavefront. An EMPTY tuple means compaction
    cannot engage (wrong specular mode, too few bounces, or the wavefront
    is at/below the cap already) — callers that care about staying jitted
    (renderer._build_chunk_fn) must route such shapes to the plain jitted
    trace instead of letting trace_compacted_static's python fallback run
    the integrator eagerly.

    RR is NOT required: env-miss and emissive-termination kill most lanes
    by mid-depth in ordinary scenes too (measured bunny 256k: alive
    100%/46%/18%/9% after depths 1-4), and every fixed-width stage
    (shading, NEE, sorts, RNG) pays full width for dead lanes. The
    reservoir stays unbiased when a cap underestimates survivors
    (S/cap reweighting), so a static halving schedule is safe."""
    if cfg.specular_mode != SPECULAR_MODE_NAIVE:
        return ()
    if schedule is None:
        if cfg.russian_roulette:
            d1 = cfg.rr_start_depth + 1
            schedule = ((d1, max(min_cap, r // 4)),
                        (d1 + 2, max(min_cap, r // 16)))
        else:
            schedule = ((2, max(min_cap, r // 2)),
                        (3, max(min_cap, r // 4)),
                        (4, max(min_cap, r // 8)))
    return tuple(
        (d, c) for (d, c) in schedule if d <= cfg.max_bounces and c < r
    )


def trace_compacted_static(
    scene: SceneData,
    cfg: IntegratorConfig,
    org,
    dirn,
    key,
    strat_idx=None,
    n_strat: int = 1,
    schedule: tuple | None = None,
    min_cap: int = 1 << 12,
):
    """Sync-free wavefront compaction (the WorkStealingScheduler.cs:9-30
    replacement without trace_compacted's one host sync, which drains the
    dispatch pipeline): capacities are FIXED at
    trace time — default R/4 lanes at rr_start+1, R/16 two depths later —
    and `_reservoir_compact` keeps the estimator unbiased even if more
    lanes survive than a cap allows. Falls back to plain (UN-jitted)
    trace() when compaction can't help — check compaction_schedule()
    first if you need the jitted path."""
    r = org.shape[0]
    schedule = compaction_schedule(cfg, r, schedule, min_cap)
    if not schedule:
        return trace(scene, cfg, org, dirn, key, strat_idx, n_strat)
    d_first = schedule[0][0]
    state, rays, alb, nrm, krest = _trace_prefix(
        scene, cfg, org, dirn, key, strat_idx, n_strat, d_first
    )
    radiance, tail_rays = _static_tail(
        scene, cfg, state, krest, schedule, cfg.max_bounces + 1
    )
    return TraceResult(radiance, alb, nrm, rays + tail_rays)


def trace_compacted(
    scene: SceneData,
    cfg: IntegratorConfig,
    org,
    dirn,
    key,
    strat_idx=None,
    n_strat: int = 1,
    compact_at: int | None = None,
    min_cap: int = 1 << 12,
):
    """trace() with one host-synced compaction point: depths up to
    `compact_at` (default rr_start_depth + 1) run at full width; survivors
    are then argsort-compacted on device into the smallest power-of-two
    buffer and the remaining depths run at that width. Falls back to plain
    trace() when compaction can't help (no RR, branch-split modes, or
    nothing culled)."""
    if cfg.specular_mode != SPECULAR_MODE_NAIVE or not cfg.russian_roulette:
        return trace(scene, cfg, org, dirn, key, strat_idx, n_strat)
    d_stop = compact_at if compact_at is not None else cfg.rr_start_depth + 1
    d_stop = min(d_stop, cfg.max_bounces + 1)
    state, rays, alb, nrm, krest = _trace_prefix(
        scene, cfg, org, dirn, key, strat_idx, n_strat, d_stop
    )
    if d_stop > cfg.max_bounces:
        return TraceResult(state.radiance, alb, nrm, rays)

    r = org.shape[0]
    n_alive = int(jnp.sum(state.alive))  # the one host sync
    cap = max(min_cap, 1 << max(0, (n_alive - 1)).bit_length())
    if cap >= r:  # nothing culled: finish at full width
        state, rays = _trace_span_jit(scene, cfg, state, rays, krest,
                                      d_stop, cfg.max_bounces + 1)
        return TraceResult(state.radiance, alb, nrm, rays)

    radiance, tail_rays = _compact_and_finish(
        scene, cfg, state, krest, cap, d_stop, cfg.max_bounces + 1
    )
    return TraceResult(radiance, alb, nrm, rays + tail_rays)
