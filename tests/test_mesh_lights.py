"""Per-triangle emissive mesh lights: NEE area sampling must agree with the
naive (no-NEE) estimator — both target the same integral (VERDICT item 7;
reference registers any emissive shape as a light, Scene.cs:29-38)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.camera import Camera
from ptsharp.geometry.mesh import TriMesh, quad_mesh
from ptsharp.integrator import IntegratorConfig, trace
from ptsharp.materials import diffuse_material, light_material
from ptsharp.scene import SceneBuilder


def _trace_grid(scene, icfg, spp, seed=0, n=8):
    """Average radiance over a grid of downward rays onto the floor around
    the origin."""
    xs = np.linspace(-0.8, 0.8, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    org1 = np.stack([gx, np.full_like(gx, 3.0), gz], -1).reshape(-1, 3)
    org = jnp.asarray(np.repeat(org1, spp, axis=0))
    dirn = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), org.shape)
    res = trace(scene, icfg, org, dirn, jax.random.PRNGKey(seed))
    return np.asarray(res.radiance).reshape(n * n, spp, 3).mean(axis=1)


def _quad_light_scene():
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    q = quad_mesh([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])
    b.add_mesh(q, light_material([1.0, 0.9, 0.8], 4.0))
    b.set_environment(color=[0.0, 0.0, 0.0])
    return b.build(leaf_size=4)


def test_quad_light_registered():
    s = _quad_light_scene()
    assert s.num_lights == 1
    assert s.em_v0.shape[0] == 2  # two emissive triangles
    np.testing.assert_allclose(float(s.light_area[0]), 4.0, rtol=1e-5)  # 2x2 quad
    # cdf ends at 1, areas equal -> midpoint 0.5
    np.testing.assert_allclose(np.asarray(s.em_cdf), [0.5, 1.0], rtol=1e-5)


@pytest.mark.slow
def test_quad_light_nee_matches_naive():
    s = _quad_light_scene()
    nee = _trace_grid(s, IntegratorConfig(max_bounces=1), spp=2048)
    naive = _trace_grid(
        s, IntegratorConfig(max_bounces=2, direct_lighting=False), spp=8192,
        seed=1,
    )
    assert np.isfinite(nee).all() and np.isfinite(naive).all()
    assert nee.mean() > 0.05  # light actually contributes
    np.testing.assert_allclose(nee.mean(), naive.mean(), rtol=0.05)
    np.testing.assert_allclose(nee.mean(0), naive.mean(0), rtol=0.08)


def test_partially_emissive_mesh_ke_path():
    """A mesh whose per-triangle materials include one emissive triangle
    (the OBJ Ke case): registered as a light, and shadow rays hitting the
    non-emissive half do not count as visible."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.6, 0.6, 0.6]))
    dark = b.material_id(diffuse_material([0.1, 0.1, 0.1]))
    lit = b.material_id(light_material([1.0, 1.0, 1.0], 6.0))
    q = quad_mesh([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])
    q2 = TriMesh(v=q.v, uv=q.uv, mat=np.array([lit, dark], np.int32))
    b.add_mesh(q2)
    b.set_environment(color=[0.0, 0.0, 0.0])
    s = b.build(leaf_size=4)
    assert s.num_lights == 1
    assert s.em_v0.shape[0] == 1  # only the emissive triangle is sampled
    np.testing.assert_allclose(float(s.light_area[0]), 2.0, rtol=1e-5)

    nee = _trace_grid(s, IntegratorConfig(max_bounces=1), spp=2048)
    naive = _trace_grid(
        s, IntegratorConfig(max_bounces=2, direct_lighting=False), spp=8192,
        seed=1,
    )
    assert nee.mean() > 0.02
    np.testing.assert_allclose(nee.mean(), naive.mean(), rtol=0.06)


@pytest.mark.slow
def test_transformed_emissive_instance():
    """Mesh-light geometry follows the instance transform."""
    from ptsharp.core.transform import translate

    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    q = quad_mesh([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1])
    b.add_mesh(q, light_material([1, 1, 1], 4.0), transform=translate([0, 2, 0]))
    s = b.build(leaf_size=4)
    assert s.num_lights == 1
    np.testing.assert_allclose(np.asarray(s.em_v0)[:, 1], 2.0, atol=1e-6)
    nee = _trace_grid(s, IntegratorConfig(max_bounces=1), spp=1024)
    assert np.isfinite(nee).all() and nee.mean() > 0.05
