"""Power-CDF light selection (LIGHT_MODE_POWER): estimator parity with
the exact per-light sum (LIGHT_MODE_ALL) and flat scaling in light count
(reference runway class, Example.cs:1028-1082)."""

import pytest
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.integrator import IntegratorConfig, trace
from ptsharp.materials import diffuse_material, light_material
from ptsharp.scene import SceneBuilder


def _lights_scene(n_lights):
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.6, 0.6, 0.6]))
    rng = np.random.default_rng(1)
    for i in range(n_lights):
        p = [float(rng.uniform(-8, 8)), float(rng.uniform(2, 5)),
             float(rng.uniform(-8, 8))]
        e = float(rng.uniform(1.0, 12.0))
        c = rng.uniform(0.3, 1.0, 3)
        b.add_sphere(p, 0.4, light_material(c, e))
    return b.build()


def _down_rays(n, key):
    ju, jv = jax.random.uniform(key, (2, n))
    org = jnp.stack([ju * 12 - 6, jnp.full(n, 4.0), jv * 12 - 6], axis=-1)
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (n, 1))
    return org, d


@pytest.mark.slow
def test_power_mode_matches_random_mode_expectation():
    """POWER and RANDOM are both sum estimators (the reference's RANDOM
    multiplies by nLights, Sampler.cs:205-209; ALL divides — the two
    reference modes differ by design). Same expectation, different pick
    distribution."""
    scene = _lights_scene(6)
    key = jax.random.PRNGKey(0)
    org, d = _down_rays(8192, key)
    cfg = IntegratorConfig(max_bounces=1)
    means = {}
    for mode in ("random", "power"):
        acc = 0.0
        n_rep = 8
        for i in range(n_rep):
            r_p = trace(scene, replace(cfg, light_mode=mode), org, d,
                        jax.random.fold_in(key, i))
            acc = acc + np.asarray(r_p.radiance)
        means[mode] = (acc / n_rep).mean()
    assert abs(means["power"] - means["random"]) / means["random"] < 0.05, \
        means


def test_power_mode_flat_in_light_count():
    """Trace graph size / compile time must not grow with light count
    (the ALL mode unrolls; POWER must not)."""
    key = jax.random.PRNGKey(3)
    cfg = IntegratorConfig(max_bounces=1, light_mode="power")
    sizes = []
    # both counts sit above the TLAS-dispatch threshold (>= 64 analytic
    # objects) so the traversal structure is identical; only light count
    # varies
    for n in (70, 140):
        scene = _lights_scene(n)
        org, d = _down_rays(256, key)
        jaxpr = jax.make_jaxpr(
            lambda s, o, dd: trace(s, cfg, o, dd, key).radiance
        )(scene, org, d)
        sizes.append(len(jaxpr.jaxpr.eqns))
    assert sizes[1] == sizes[0], sizes


def test_runway_example_smokes():
    from ptsharp import examples

    scene, cam, _rcfg, icfg = examples.build("runway")
    assert scene.num_lights > 100
    assert icfg.light_mode == "power"
    key = jax.random.PRNGKey(0)
    px = jnp.arange(1024) % 512
    py = 150 + (jnp.arange(1024) // 512) * 40
    ju, jv = jax.random.uniform(key, (2, 1024))
    org, d = cam.cast_rays(px, py, 512, 288, ju, jv)
    res = trace(scene, icfg, org, d, key)
    img = np.asarray(res.radiance)
    assert np.isfinite(img).all()
    assert img.mean() > 0
