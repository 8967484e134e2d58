"""Gradient checks: AD through the wavefront integrator vs central finite
differences on material / emitter parameters (SURVEY.md §7 step 8)."""

import pytest
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.camera import Camera
from ptsharp.diff import render_image
from ptsharp.integrator import IntegratorConfig
from ptsharp.materials import diffuse_material, light_material
from ptsharp.scene import SceneBuilder


def _scene():
    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.6, 0.3, 0.2]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 6.0))
    b.set_environment(color=[0.05, 0.05, 0.05])
    return b.build()


SCENE = _scene()
CAM = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)
CFG = IntegratorConfig(max_bounces=2)
KEY = jax.random.PRNGKey(11)
W = H = 8
SPP = 32


def _img_for(colors=None, emit=None):
    mats = SCENE.materials
    if colors is not None:
        mats = mats._replace(color=colors)
    if emit is not None:
        mats = mats._replace(emittance=emit)
    return render_image(replace(SCENE, materials=mats), CAM, CFG, KEY, W, H, SPP)


def test_grad_matches_fd_material_color():
    """d(mean image)/d(red channel of sphere albedo): AD vs central FD.
    Same PRNG key on both sides -> common random numbers -> FD is exact up
    to fp32 noise even at low spp."""

    def scalar_loss(c):
        colors = SCENE.materials.color.at[0, 0].set(c)
        return jnp.mean(_img_for(colors=colors))

    g_ad = jax.grad(scalar_loss)(jnp.float32(0.6))
    eps = 1e-2
    f1 = scalar_loss(jnp.float32(0.6 + eps))
    f0 = scalar_loss(jnp.float32(0.6 - eps))
    g_fd = (f1 - f0) / (2 * eps)
    np.testing.assert_allclose(float(g_ad), float(g_fd), rtol=0.05, atol=1e-4)
    assert float(g_ad) > 0.0  # brighter albedo -> brighter image


def test_grad_matches_fd_emittance():
    def scalar_loss(e):
        emit = SCENE.materials.emittance.at[2].set(e)
        return jnp.mean(_img_for(emit=emit))

    g_ad = jax.grad(scalar_loss)(jnp.float32(6.0))
    eps = 5e-2
    g_fd = (scalar_loss(jnp.float32(6.0 + eps)) - scalar_loss(jnp.float32(6.0 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(g_ad), float(g_fd), rtol=0.05, atol=1e-5)
    assert float(g_ad) > 0.0


def test_grad_env_color():
    def scalar_loss(e):
        return jnp.mean(render_image(replace(SCENE, env_color=e), CAM, CFG, KEY, W, H, SPP))

    g = jax.grad(scalar_loss)(jnp.asarray(SCENE.env_color))
    assert np.all(np.asarray(g) >= 0.0)
    assert np.asarray(g).sum() > 0.0


@pytest.mark.slow
def test_grad_through_mesh_scene_is_finite():
    """BVH traversal is stop-gradiented; grads w.r.t. materials must still
    be finite and nonzero in a mesh scene."""
    from ptsharp.geometry.mesh import cube_mesh

    b = SceneBuilder()
    b.add_mesh(cube_mesh([-1, 0, -1], [1, 2, 1]), diffuse_material([0.5, 0.5, 0.5]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 6.0))
    scene = b.build(leaf_size=4)

    def loss(colors):
        mats = scene.materials._replace(color=colors)
        img = render_image(replace(scene, materials=mats), CAM,
                           IntegratorConfig(max_bounces=2), KEY, 6, 6, 8)
        return jnp.mean(img)

    g = jax.grad(loss)(scene.materials.color)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0.0


@pytest.mark.slow
def test_grad_compacted_matches_plain():
    """Gradient through trace_compacted_static vs plain trace (the grad
    bench runs the compacted path: dead lanes cost double in fwd+bwd,
    scripts/exp_grad4.py). Same key chain -> near-identical gradients up
    to the ~1% lane divergence of fusion-dependent RR coin rounding."""
    from ptsharp.integrator import trace, trace_compacted_static

    cfg = IntegratorConfig(max_bounces=6, russian_roulette=True,
                           rr_start_depth=2)
    n = 4096
    rng = np.random.default_rng(5)
    org = jnp.asarray(
        rng.uniform(-2, 2, (n, 3)).astype(np.float32) * [1, 0.2, 1]
        + [0, 2.0, -5.0])
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)
                    + [0, -0.3, 1.0])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    def loss(colors, tracer):
        mats = SCENE.materials._replace(color=colors)
        s = replace(SCENE, materials=mats)
        res = tracer(s, cfg, org, d, KEY)
        return jnp.mean(res.radiance)

    g_plain = jax.grad(lambda c: loss(c, trace))(SCENE.materials.color)
    g_comp = jax.grad(
        lambda c: loss(c, lambda *a, **k: trace_compacted_static(
            *a, min_cap=256, **k)))(SCENE.materials.color)
    gp = np.asarray(g_plain)
    gc = np.asarray(g_comp)
    denom = max(float(np.abs(gp).max()), 1e-8)
    assert np.abs(gp - gc).max() / denom < 0.05, (gp, gc)
