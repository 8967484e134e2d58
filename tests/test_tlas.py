"""TLAS correctness: the unified top-level traversal (intersect.traverse_scene)
must agree exactly with the brute-force per-type passes + per-instance BVH
loops on heterogeneous scenes (the reference's top-level tree, Tree.cs:22-42,
Scene.cs:56-66)."""

import pytest
import math

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.core.transform import rotate, translate, scale
from ptsharp.geometry.mesh import cube_mesh, sphere_mesh
from ptsharp.intersect import closest_hit, hit_info
from ptsharp.materials import diffuse_material, light_material
from ptsharp.scene import SceneBuilder


def _hetero_builder():
    b = SceneBuilder()
    red = diffuse_material([0.8, 0.2, 0.2])
    green = diffuse_material([0.2, 0.8, 0.2])
    rng = np.random.default_rng(7)
    for i in range(12):
        p = rng.uniform(-4, 4, 3)
        b.add_sphere(p, rng.uniform(0.3, 0.9), red)
    for i in range(10):
        p = rng.uniform(-4, 4, 3)
        b.add_cube(p, p + rng.uniform(0.3, 1.2, 3), green)
    for i in range(6):
        t = translate(rng.uniform(-3, 3, 3)) @ rotate([0, 1, 0], rng.uniform(0, 6))
        b.add_cylinder(0.4, -0.6, 0.6, red, transform=t)
    # transformed sphere (ellipsoid path)
    b.add_sphere([0, 0, 0], 1.0, green,
                 transform=translate([0, 2.5, 0]) @ scale([1.6, 0.5, 0.9]))
    # mesh + instances
    m = sphere_mesh([0, 0, 0], 0.8, subdivisions=2)
    mid = b.add_mesh(m, diffuse_material([0.5, 0.5, 0.9]))
    for i in range(4):
        t = translate(rng.uniform(-3, 3, 3)) @ rotate([1, 1, 0], rng.uniform(0, 6)) \
            @ scale([1.0, 1.3, 0.7])
        b.add_mesh_instance(mid, transform=t)
    m2 = cube_mesh([-0.4, -0.4, -0.4], [0.4, 0.4, 0.4])
    b.add_mesh(m2, diffuse_material([0.9, 0.8, 0.2]),
               transform=translate([2, -2, 1]))
    b.add_plane([0, -6, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([6, 8, -6], 1.0, light_material([1, 1, 1], 5.0))
    return b


def _rand_rays(n, seed=3):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def test_tlas_matches_bruteforce():
    b = _hetero_builder()
    s_tlas = b.build(leaf_size=4, use_tlas=True)
    s_brute = b.build(leaf_size=4, use_tlas=False)
    assert s_tlas.use_tlas and not s_brute.use_tlas

    org, dirn = _rand_rays(4096)
    h1 = jax.jit(closest_hit)(s_tlas, org, dirn)
    h2 = jax.jit(closest_hit)(s_brute, org, dirn)

    np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t),
                               rtol=1e-4, atol=1e-4)
    hit_mask = np.asarray(h2.t) < 1e8
    assert hit_mask.sum() > 200  # the scene is actually being hit
    np.testing.assert_array_equal(
        np.asarray(h1.ptype)[hit_mask], np.asarray(h2.ptype)[hit_mask]
    )
    # where the same primitive wins, shading info must agree
    same = hit_mask & (np.asarray(h1.pindex) == np.asarray(h2.pindex)) \
        & (np.asarray(h1.inst) == np.asarray(h2.inst))
    i1 = hit_info(s_tlas, org, dirn, h1)
    i2 = hit_info(s_brute, org, dirn, h2)
    np.testing.assert_allclose(
        np.asarray(i1.normal)[same], np.asarray(i2.normal)[same],
        rtol=1e-3, atol=1e-3,
    )
    np.testing.assert_array_equal(
        np.asarray(i1.mat_id)[same], np.asarray(i2.mat_id)[same]
    )


def test_tlas_auto_heuristic():
    # many instances -> auto TLAS; tiny scene -> brute force
    b = _hetero_builder()
    assert b.build(leaf_size=4).use_tlas  # 5+ instances
    b2 = SceneBuilder()
    b2.add_sphere([0, 0, 0], 1.0, diffuse_material([0.5, 0.5, 0.5]))
    assert not b2.build().use_tlas


@pytest.mark.slow
def test_tlas_render_smoke():
    """A full render through the TLAS path stays finite and matches the
    brute-force image."""
    from ptsharp.camera import Camera
    from ptsharp.integrator import IntegratorConfig, trace

    b = _hetero_builder()
    s_tlas = b.build(leaf_size=4, use_tlas=True)
    s_brute = b.build(leaf_size=4, use_tlas=False)
    cam = Camera.look_at([0, 2, -12], [0, 0, 0], [0, 1, 0], 45.0)
    w = h = 24
    xs = jnp.arange(w * h, dtype=jnp.int32)
    px, py = xs % w, xs // w
    ju = jnp.full((w * h,), 0.5)
    org, dirn = cam.cast_rays(px, py, w, h, ju, ju)
    icfg = IntegratorConfig(max_bounces=2)
    key = jax.random.PRNGKey(0)
    r1 = trace(s_tlas, icfg, org, dirn, key).radiance
    r2 = trace(s_brute, icfg, org, dirn, key).radiance
    assert bool(jnp.isfinite(r1).all())
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), rtol=1e-3,
                               atol=1e-3)
