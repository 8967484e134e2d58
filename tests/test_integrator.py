"""Integrator correctness: analytic invariants + golden parity against the
independent scalar numpy tracer (the estimator-expectation comparison
SURVEY.md §7 prescribes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptsharp.camera import Camera
from ptsharp.integrator import IntegratorConfig, trace
from ptsharp.materials import (
    diffuse_material,
    light_material,
    metallic_material,
    specular_material,
)
from ptsharp.renderer import Renderer, RenderConfig
from ptsharp.scene import SceneBuilder

from tests import reference_tracer as ref


def _trace_image(scene, cam, w, h, spp, icfg, seed=0):
    r = Renderer(
        scene, cam, RenderConfig(width=w, height=h, spp=spp), icfg
    )
    film = r.render(key=jax.random.PRNGKey(seed))
    return np.asarray(film.mean)


def test_env_only():
    """Rays that hit nothing return the environment color."""
    b = SceneBuilder()
    b.add_sphere([0, -100, 0], 1.0, diffuse_material([1, 1, 1]))  # out of view
    b.set_environment(color=[0.2, 0.4, 0.6])
    scene = b.build()
    cam = Camera.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0], 45.0)
    img = _trace_image(scene, cam, 8, 8, 4, IntegratorConfig(max_bounces=1))
    np.testing.assert_allclose(img, np.broadcast_to([0.2, 0.4, 0.6], img.shape),
                               atol=1e-5)


def test_diffuse_under_uniform_env_is_albedo():
    """A diffuse plane under a uniform environment with cosine importance
    sampling estimates exactly albedo * env (zero variance): the plane
    analogue of the white-furnace test."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.5, 0.5, 0.5]))
    b.set_environment(color=[1.0, 1.0, 1.0])
    scene = b.build()
    cam = Camera.look_at([0, 3, 0.01], [0, 0, 0], [0, 1, 0], 40.0)
    icfg = IntegratorConfig(max_bounces=2, direct_lighting=False)
    img = _trace_image(scene, cam, 8, 8, 8, icfg)
    np.testing.assert_allclose(img, 0.5, atol=1e-3)


def test_emissive_direct_view():
    """Looking straight at a light shows emittance * color."""
    b = SceneBuilder()
    b.add_sphere([0, 0, 0], 1.0, light_material([1.0, 0.8, 0.6], 5.0))
    scene = b.build()
    cam = Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 20.0)
    img = _trace_image(scene, cam, 6, 6, 4, IntegratorConfig(max_bounces=1))
    center = img[3, 3]
    np.testing.assert_allclose(center, [5.0, 4.0, 3.0], rtol=1e-3)


def test_mirror_reflection():
    """A perfect mirror plane reflects the environment gradient."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], metallic_material([1, 1, 1], 0.0, 0.0))
    b.set_environment(color=[0.3, 0.6, 0.9])
    scene = b.build()
    cam = Camera.look_at([0, 2, -4], [0, 0, 0], [0, 1, 0], 45.0)
    img = _trace_image(scene, cam, 8, 8, 4, IntegratorConfig(max_bounces=2))
    # every path: either miss -> env, or mirror bounce -> env; so all env
    np.testing.assert_allclose(
        img, np.broadcast_to([0.3, 0.6, 0.9], img.shape), atol=1e-3
    )


def test_nee_matches_reference_tracer():
    """Converged parity with the independent scalar tracer on the
    BASELINE config-#1 scene (sphere + plane + sphere light)."""
    mat_r = diffuse_material([0.7, 0.2, 0.2])
    mat_w = diffuse_material([0.8, 0.8, 0.8])

    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, mat_r)
    b.add_plane([0, 0, 0], [0, 1, 0], mat_w)
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.1, 0.1, 0.1])
    scene = b.build()
    cam = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)
    icfg = IntegratorConfig(max_bounces=3)
    w = h = 6
    img = _trace_image(scene, cam, w, h, 512, icfg)

    rscene = ref.RefScene(
        [
            ref.Sph(np.array([0.0, 1, 0]), 1.0, ref.Mat(np.array([0.7, 0.2, 0.2]))),
            ref.Pln(np.array([0.0, 0, 0]), np.array([0.0, 1, 0]),
                    ref.Mat(np.array([0.8, 0.8, 0.8]))),
            ref.Sph(np.array([3.0, 6, -3]), 1.5,
                    ref.Mat(np.array([1.0, 1, 1]), emittance=8.0)),
        ],
        env=(0.1, 0.1, 0.1),
    )
    ref_img = ref.render(rscene, [0, 2, -6], [0, 1, 0], 40.0, w, h, 512, 3, seed=3)

    # Monte-Carlo convergence tolerance: both estimators target the same
    # integral; compare means loosely + per-pixel within noise
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref_img.mean(), rtol=0.05)
    np.testing.assert_allclose(img, ref_img, atol=0.25)


def test_specular_glass_matches_reference():
    """Fresnel-weighted specular/refraction parity on a glass sphere."""
    b = SceneBuilder()
    b.add_sphere([0, 0, 0], 1.0, specular_material([1, 1, 1], 1.5))
    b.set_environment(color=[0.5, 0.5, 0.5])
    scene = b.build()
    cam = Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 35.0)
    icfg = IntegratorConfig(max_bounces=4, direct_lighting=False)
    w = h = 6
    img = _trace_image(scene, cam, w, h, 256, icfg)

    rscene = ref.RefScene(
        [ref.Sph(np.array([0.0, 0, 0]), 1.0,
                 ref.Mat(np.array([1.0, 1, 1]), index=1.5))],
        env=(0.5, 0.5, 0.5),
    )
    ref_img = ref.render(rscene, [0, 0, -4], [0, 0, 0], 35.0, w, h, 256, 4, seed=5)
    np.testing.assert_allclose(img.mean(), ref_img.mean(), rtol=0.08)


def test_determinism():
    """Same key -> bitwise-identical render (the reproducibility the
    reference's Random.Shared can never give)."""
    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.7, 0.2, 0.2]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([2, 5, -2], 1.0, light_material([1, 1, 1], 10.0))
    scene = b.build()
    cam = Camera.look_at([0, 2, -5], [0, 1, 0], [0, 1, 0], 45.0)
    icfg = IntegratorConfig(max_bounces=2)
    img1 = _trace_image(scene, cam, 8, 8, 4, icfg, seed=7)
    img2 = _trace_image(scene, cam, 8, 8, 4, icfg, seed=7)
    np.testing.assert_array_equal(img1, img2)


def test_ray_counter():
    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.7, 0.2, 0.2]))
    b.add_sphere([2, 5, -2], 1.0, light_material([1, 1, 1], 10.0))
    scene = b.build()
    cam = Camera.look_at([0, 2, -5], [0, 1, 0], [0, 1, 0], 45.0)
    r = Renderer(scene, cam, RenderConfig(width=8, height=8, spp=2),
                 IntegratorConfig(max_bounces=2))
    r.render(key=jax.random.PRNGKey(0))
    assert r.rays_traced >= 8 * 8 * 2  # at least the primary rays
