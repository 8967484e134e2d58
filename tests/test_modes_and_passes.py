"""VERDICT round-1 test gaps: SpecularMode All, adaptive/firefly pass
correctness, texture-parameter gradients."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.camera import Camera
from ptsharp.integrator import (
    SPECULAR_MODE_ALL,
    SPECULAR_MODE_FIRST,
    IntegratorConfig,
    trace,
)
from ptsharp.materials import (
    diffuse_material,
    glossy_material,
    light_material,
)
from ptsharp.renderer import RenderConfig, Renderer
from ptsharp.scene import SceneBuilder


def _gloss_scene():
    """Glossy floor + diffuse sphere + light: both specular and diffuse
    branches carry energy, so the estimators differ only in variance."""
    b = SceneBuilder()
    import math

    b.add_plane([0, 0, 0], [0, 1, 0],
                glossy_material([0.7, 0.7, 0.7], 1.5, math.radians(20)))
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.6, 0.3, 0.2]))
    b.add_sphere([3, 5, -3], 1.2, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.2, 0.25, 0.3])
    return b.build()


def _render_mean(scene, icfg, spp, seed=0, n=6):
    cam = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)
    xs = jnp.arange(n * n, dtype=jnp.int32)
    px, py = xs % n, xs // n
    px = jnp.tile(px, spp)
    py = jnp.tile(py, spp)
    key = jax.random.PRNGKey(seed)
    kj, kt = jax.random.split(key)
    ju, jv = jax.random.uniform(kj, (2, px.shape[0]))
    org, dirn = cam.cast_rays(px, py, n, n, ju, jv)
    res = trace(scene, icfg, org, dirn, kt)
    return np.asarray(res.radiance).reshape(spp, n * n, 3).mean(axis=0)


@pytest.mark.slow
def test_specular_mode_all_same_expectation():
    """SpecularModeAll (bounded branch split every early bounce,
    Sampler.cs:85-94) targets the same integral as naive and first."""
    scene = _gloss_scene()
    base = _render_mean(
        scene, IntegratorConfig(max_bounces=3), spp=1024)
    allm = _render_mean(
        scene,
        IntegratorConfig(max_bounces=3, specular_mode=SPECULAR_MODE_ALL),
        spp=256, seed=1)
    firstm = _render_mean(
        scene,
        IntegratorConfig(max_bounces=3, specular_mode=SPECULAR_MODE_FIRST),
        spp=256, seed=2)
    np.testing.assert_allclose(allm.mean(), base.mean(), rtol=0.05)
    np.testing.assert_allclose(firstm.mean(), base.mean(), rtol=0.05)


def test_specular_mode_all_reduces_variance():
    """Branch splitting trades rays for variance: per-sample variance of the
    All estimator must not exceed naive's on a specular-heavy scene."""
    scene = _gloss_scene()
    cam = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)

    def var_of(icfg, seed):
        n, spp = 4, 256
        xs = jnp.arange(n * n, dtype=jnp.int32)
        px = jnp.tile(xs % n, spp)
        py = jnp.tile(xs // n, spp)
        kj, kt = jax.random.split(jax.random.PRNGKey(seed))
        ju, jv = jax.random.uniform(kj, (2, px.shape[0]))
        org, dirn = cam.cast_rays(px, py, n, n, ju, jv)
        res = trace(scene, icfg, org, dirn, kt)
        lum = np.asarray(res.radiance).mean(-1).reshape(spp, n * n)
        return lum.var(axis=0).mean()

    v_naive = var_of(IntegratorConfig(max_bounces=3), 3)
    v_all = var_of(
        IntegratorConfig(max_bounces=3, specular_mode=SPECULAR_MODE_ALL), 3)
    assert v_all <= v_naive * 1.1


def test_adaptive_pass_targets_high_variance():
    """Adaptive sampling puts extra samples where stddev is high
    (Renderer.cs:340-416) and leaves the film unbiased."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([0, 1.2, 0], 1.0, light_material([1, 1, 1], 30.0))
    b.set_environment(color=[0.02, 0.02, 0.02])
    scene = b.build()
    cam = Camera.look_at([0, 2.5, -5], [0, 0.8, 0], [0, 1, 0], 45.0)
    cfg = RenderConfig(width=32, height=32, spp=8, adaptive_samples=16,
                       adaptive_threshold=0.2)
    r = Renderer(scene, cam, cfg, IntegratorConfig(max_bounces=2))
    film = r.render(key=jax.random.PRNGKey(0))
    n = np.asarray(film.n)
    assert n.max() > 8  # some pixels got extra samples
    assert n.min() >= 8  # nobody lost base samples
    # extra samples correlate with variance: pixels with extra samples had
    # higher base variance on average
    base = Renderer(scene, cam, RenderConfig(width=32, height=32, spp=8),
                    IntegratorConfig(max_bounces=2))
    f0 = base.render(key=jax.random.PRNGKey(0))
    std0 = np.asarray(jnp.mean(f0.stddev(), -1))
    assert n.max() > n.min()  # sample counts are variance-driven, not flat
    hi = n >= np.quantile(n, 0.75)
    lo = n <= np.quantile(n, 0.25)
    assert std0[hi].mean() > std0[lo].mean()
    # weighted Welford stays finite/unbiased-ish
    img = np.asarray(film.color_srgb())
    assert np.isfinite(img).all()


def test_firefly_pass_resamples_outliers():
    """Firefly pass adds samples exactly where stddev exceeds the threshold
    (Renderer.cs:418-468)."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([2, 3, 0], 0.3, light_material([1, 1, 1], 200.0))
    b.set_environment(color=[0.02, 0.02, 0.02])
    scene = b.build()
    cam = Camera.look_at([0, 2.5, -5], [0, 0.8, 0], [0, 1, 0], 45.0)
    cfg = RenderConfig(width=24, height=24, spp=8, firefly_samples=8,
                       firefly_threshold=0.5)
    r = Renderer(scene, cam, cfg, IntegratorConfig(max_bounces=2))
    film = r.render(key=jax.random.PRNGKey(1))
    n = np.asarray(film.n)
    assert n.max() == 16 and n.min() == 8  # outlier pixels resampled
    assert np.isfinite(np.asarray(film.color_srgb())).all()


@pytest.mark.slow
def test_texture_parameter_gradient():
    """North star: radiance must differentiate w.r.t. texture atlas texels
    (bilinear sampling is smooth). AD gradient vs finite differences."""
    import dataclasses

    b = SceneBuilder()
    tex = np.full((4, 4, 3), 0.5, np.float32)
    tid = b.add_texture(tex)
    from ptsharp.materials import Material

    b.add_plane([0, 0, 0], [0, 1, 0], Material(color=(1, 1, 1), texture=tid))
    b.add_sphere([0, 4, 0], 1.0, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.1, 0.1, 0.1])
    scene = b.build()
    cam = Camera.look_at([0, 3, -4], [0, 0, 0], [0, 1, 0], 40.0)

    n = 4
    xs = jnp.arange(n * n, dtype=jnp.int32)
    px, py = xs % n, xs // n
    ju = jnp.full((n * n,), 0.5)
    org, dirn = cam.cast_rays(px, py, n, n, ju, ju)
    icfg = IntegratorConfig(max_bounces=1)
    key = jax.random.PRNGKey(0)

    def loss(tex_data):
        s = dataclasses.replace(
            scene, textures=scene.textures._replace(data=tex_data))
        return jnp.mean(trace(s, icfg, org, dirn, key).radiance)

    g = jax.grad(loss)(scene.textures.data)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0  # texels actually receive gradient

    # finite-difference check on the largest-gradient texel
    flat = np.abs(g).reshape(-1)
    i = int(flat.argmax())
    eps = 1e-2
    base_np = np.asarray(scene.textures.data)
    up = base_np.reshape(-1).copy()
    up[i] += eps
    dn = base_np.reshape(-1).copy()
    dn[i] -= eps
    f_up = float(loss(jnp.asarray(up.reshape(base_np.shape))))
    f_dn = float(loss(jnp.asarray(dn.reshape(base_np.shape))))
    fd = (f_up - f_dn) / (2 * eps)
    np.testing.assert_allclose(g.reshape(-1)[i], fd, rtol=0.05, atol=1e-6)
