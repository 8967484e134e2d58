"""Analytic tape backward (tape.py): primal bit-parity with trace() and
gradient parity with AD for every leaf of the DiffParams contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from dataclasses import replace

from ptsharp import examples
from ptsharp.integrator import IntegratorConfig, trace
from ptsharp.tape import tape_supported, trace_tape_radiance


def _rays(cam, r, w, h, key):
    xs = jnp.arange(r, dtype=jnp.int32)
    ju, jv = jax.random.uniform(key, (2, r))
    return cam.cast_rays(xs % w, (xs // w) % h, w, h, ju, jv)


def test_tape_primal_bit_parity_cornell():
    scene, cam, _rc, icfg = examples.build("cornell")
    key = jax.random.PRNGKey(3)
    org, dirn = _rays(cam, 2048, 640, 360, key)
    a = trace(scene, icfg, org, dirn, key)
    b = trace_tape_radiance(scene, icfg, org, dirn, key)
    # same _step, same key chain -> identical radiance
    assert jnp.array_equal(a.radiance, b.radiance)
    assert int(a.rays_traced) == int(b.rays_traced)


def test_tape_grads_match_ad_cornell():
    scene, cam, _rc, icfg = examples.build("cornell")
    key = jax.random.PRNGKey(5)
    org, dirn = _rays(cam, 2048, 640, 360, key)

    def pair(plug):
        def la(x):
            return jnp.mean(trace(plug(x), icfg, org, dirn, key).radiance)

        def lt(x):
            return jnp.mean(
                trace_tape_radiance(plug(x), icfg, org, dirn, key).radiance)

        return la, lt

    la, lt = pair(lambda c: replace(
        scene, materials=scene.materials._replace(color=c)))
    ga = jax.grad(la)(scene.materials.color)
    gt = jax.grad(lt)(scene.materials.color)
    assert jnp.allclose(ga, gt, rtol=1e-3, atol=1e-7), (
        np.abs(ga - gt).max())

    la, lt = pair(lambda e: replace(
        scene, materials=scene.materials._replace(emittance=e)))
    ga = jax.grad(la)(scene.materials.emittance)
    gt = jax.grad(lt)(scene.materials.emittance)
    assert jnp.allclose(ga, gt, rtol=1e-3, atol=1e-7)


@pytest.mark.slow
def test_tape_grads_match_ad_textured_env_mesh():
    scene, cam, _rc, icfg = examples.build("bunny", width=64, height=64,
                                           subdivisions=3)
    key = jax.random.PRNGKey(7)
    org, dirn = _rays(cam, 1024, 64, 64, key)

    def la(tex):
        s = replace(scene, textures=scene.textures._replace(data=tex))
        return jnp.mean(trace(s, icfg, org, dirn, key).radiance)

    def lt(tex):
        s = replace(scene, textures=scene.textures._replace(data=tex))
        return jnp.mean(trace_tape_radiance(s, icfg, org, dirn, key).radiance)

    ga = jax.grad(la)(scene.textures.data)
    gt = jax.grad(lt)(scene.textures.data)
    assert jnp.allclose(ga, gt, rtol=1e-3, atol=1e-9)
    assert float(jnp.abs(gt).max()) > 0

    def lae(c):
        return jnp.mean(
            trace(replace(scene, env_color=c), icfg, org, dirn, key).radiance)

    def lte(c):
        return jnp.mean(trace_tape_radiance(
            replace(scene, env_color=c), icfg, org, dirn, key).radiance)

    ga = jax.grad(lae)(jnp.asarray(scene.env_color))
    gt = jax.grad(lte)(jnp.asarray(scene.env_color))
    assert jnp.allclose(ga, gt, rtol=1e-4)


def test_tape_fallback_unsupported_modes():
    scene, cam, _rc, _ic = examples.build("cornell")
    cfg = IntegratorConfig(max_bounces=3, specular_mode="first")
    assert not tape_supported(scene, cfg)
    key = jax.random.PRNGKey(1)
    org, dirn = _rays(cam, 512, 64, 64, key)
    a = trace(scene, cfg, org, dirn, key)
    b = trace_tape_radiance(scene, cfg, org, dirn, key)  # falls back
    assert jnp.array_equal(a.radiance, b.radiance)
