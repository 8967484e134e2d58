"""Differentiable rendering entry points.

The BASELINE north star requires per-pixel radiance differentiable w.r.t.
material, texture, and emitter parameters. The integrator is already a pure
function of `SceneData` (a pytree whose material table / texture atlas /
light parameters are jit-traced arrays), with discrete sampling decisions
detached (branch coins, light picks, RR) and non-differentiable marches
(BVH/SDF/volume while-loops) stop-gradiented at their call sites. So
`jax.grad` through `render_image` w.r.t. those arrays is well-defined — the
score-function-free reparameterized estimator of SURVEY.md §7 step 8.

Typical use:

    def loss(mats):
        img = render_image(replace(scene, materials=mats), cam, cfg, key, w, h, spp)
        return jnp.mean((img - target) ** 2)
    g = jax.grad(loss)(scene.materials)
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp

from ptsharp.camera import Camera
from ptsharp.integrator import IntegratorConfig, trace
from ptsharp.scene import SceneData


def render_image(
    scene: SceneData,
    camera: Camera,
    cfg: IntegratorConfig,
    key,
    width: int,
    height: int,
    spp: int,
    use_tape: bool = False,
):
    """Mean radiance image (H, W, 3) — the film-free differentiable render
    used for optimization loops and gradient tests.

    use_tape: gradients via the analytic tape backward (tape.py) — same
    primal, ~1.7x faster fwd+bwd on the supported parameter contract
    (material color/emittance/tint, light params, env, texture texels);
    falls back to AD-able trace for unsupported configs."""
    ys = jnp.arange(height)
    xs = jnp.arange(width)
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    pix_x = jnp.broadcast_to(xx[None], (spp, height, width)).reshape(-1)
    pix_y = jnp.broadcast_to(yy[None], (spp, height, width)).reshape(-1)
    r = pix_x.shape[0]
    kj, kt = jax.random.split(key)
    ju, jv = jax.random.uniform(kj, (2, r))
    org, dirn = camera.cast_rays(pix_x, pix_y, width, height, ju, jv)
    if use_tape:
        from ptsharp.tape import trace_tape_radiance

        result = trace_tape_radiance(scene, cfg, org, dirn, kt)
    else:
        result = trace(scene, cfg, org, dirn, kt)
    return jnp.mean(result.radiance.reshape(spp, height, width, 3), axis=0)


def material_color_grad(scene, camera, cfg, key, width, height, spp, target):
    """Gradient of image-MSE w.r.t. the material color table — convenience
    wrapper used by tests and the multichip dry run."""

    def loss(colors):
        mats = scene.materials._replace(color=colors)
        img = render_image(
            replace(scene, materials=mats), camera, cfg, key, width, height, spp
        )
        return jnp.mean((img - target) ** 2)

    return jax.grad(loss)(scene.materials.color)
