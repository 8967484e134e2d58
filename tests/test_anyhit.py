"""Any-hit occlusion path (the NEE shadow fast path): the any-hit kernel
vs the bounded closest-hit kernel, occlusion_query vs closest-hit
visibility, and estimator parity of anyhit_shadows on/off
(Sampler.cs:261-296 visibility semantics)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.integrator import IntegratorConfig, trace
from ptsharp.intersect import closest_hit, light_hit_t, occlusion_query
from ptsharp.materials import diffuse_material, light_material
from ptsharp.intersect import _xform_dir, _xform_point
from ptsharp.pallas import traverse_gpu
from ptsharp.scene import PT_SPHERE, SceneBuilder
from ptsharp.geometry.mesh import cube_mesh, sphere_mesh


def _mesh_scene(intersector="pallas"):
    b = SceneBuilder()
    b.add_mesh(sphere_mesh([0, 0.4, 0], 1.0, subdivisions=2),
               diffuse_material([0.5, 0.5, 0.5]))
    b.add_mesh(cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
               diffuse_material([0.9, 0.6, 0.2]))
    return b.build(leaf_size=8, intersector=intersector, wide_k=8)


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) + [0.5, 0.3, 0]
    d = np.where(rng.random((n, 1)) < 0.6,
                 tgt - org, rng.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def test_anyhit_kernel_matches_closest_hit_boolean():
    """occluded(t_cut) must equal (closest-hit t < t_cut) for every ray
    and a spread of cut distances, including t_cut <= 0 lanes."""
    sp = _mesh_scene()
    org, d = _rays(512)
    rng = np.random.default_rng(3)
    t_cut = jnp.asarray(
        np.where(rng.random(512) < 0.1, -1.0,
                 rng.uniform(0.2, 6.0, 512)).astype(np.float32))
    for i in range(sp.inst_inv.shape[0]):
        inv = sp.inst_inv[i]
        o = _xform_point(inv[None], org)
        dd = _xform_dir(inv[None], d)
        args = (sp.w_rows, sp.leaf_rows, o, dd, t_cut, sp.w_inst_base[i],
                sp.w_inst_end[i], sp.max_leaf, sp.wide_k)
        t_ref, _s, _u, _v = traverse_gpu.closest_hit(*args)
        occ = traverse_gpu.occluded(*args)
        np.testing.assert_array_equal(
            np.asarray(occ), np.asarray(t_ref) < 1e8)


def test_occlusion_query_matches_closest_hit():
    """Scene-level boolean query == bounded closest-hit on both pallas and
    wide intersectors."""
    for inter in ("pallas", "wide"):
        sp = _mesh_scene(inter)
        org, d = _rays(512, seed=7)
        t_cut = jnp.full((512,), 3.0, jnp.float32)
        occ = occlusion_query(sp, org, d, t_cut)
        h = closest_hit(sp, org, d, t_max=t_cut)
        np.testing.assert_array_equal(np.asarray(occ),
                                      np.asarray(h.t) < 1e8)


def test_light_hit_t_sphere():
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([0, 5, 0], 1.0, light_material([1, 1, 1], 10.0))
    sp = b.build()
    assert sp.light_types == (PT_SPHERE,)
    org = jnp.asarray([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]], jnp.float32)
    dirn = jnp.asarray([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], jnp.float32)
    lidx = jnp.zeros(2, jnp.int32)
    t = np.asarray(light_hit_t(sp, org, dirn, lidx))
    assert abs(t[0] - 4.0) < 1e-4       # straight up into the sphere
    assert t[1] > 1e8                   # parallel line misses


def test_trace_anyhit_matches_closest_visibility():
    """Full NEE estimator with anyhit on vs off agrees in expectation
    (per-lane visibility can differ only at epsilon-grazing samples)."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_mesh(sphere_mesh([0, 0.6, 0], 0.6, subdivisions=2),
               diffuse_material([0.6, 0.3, 0.2]))
    b.add_sphere([2.0, 4.0, -1.0], 0.8, light_material([1, 1, 1], 12.0))
    sp = b.build(leaf_size=8, intersector="pallas", wide_k=8)
    icfg = IntegratorConfig(max_bounces=3)
    key = jax.random.PRNGKey(5)
    n = 2048
    rng = np.random.default_rng(11)
    org = jnp.asarray(
        rng.uniform(-2, 2, (n, 3)).astype(np.float32) * [1, 0.3, 1]
        + [0, 1.5, -3.0])
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    r_any = trace(sp, replace(icfg, anyhit_shadows=True), org, d, key)
    r_cls = trace(sp, replace(icfg, anyhit_shadows=False), org, d, key)
    a = np.asarray(r_any.radiance)
    c = np.asarray(r_cls.radiance)
    # identical RNG chain: lanes differ only where visibility eps flips
    frac_diff = np.mean(np.any(np.abs(a - c) > 1e-5, axis=-1))
    assert frac_diff < 0.02, frac_diff
    assert abs(a.mean() - c.mean()) / max(c.mean(), 1e-9) < 0.02
