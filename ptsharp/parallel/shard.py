"""SPMD rendering over a device mesh with shard_map.

Sharding layout (SURVEY.md §2 parallelism table):
  * image rows      -> "dp" axis (static tile ownership — each chip owns a
                       contiguous row block, replacing the reference's
                       work-stealing scheduler)
  * samples / pixel -> "sp" axis (wavefront sharding: each chip traces an
                       independent slice of the per-pixel sample budget)
  * scene + BVH     -> replicated (the reference's shared-memory scene)
  * film merge      -> pmean over "sp" (an NCCL all-reduce on GPUs)
  * gradients       -> psum'd automatically by shard_map's transpose when
                       jax.grad wraps the sharded render (overlapped with
                       the backward wavefront by XLA scheduling)

All functions are jit-compatible and run unchanged on a single-device mesh.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ptsharp.camera import Camera
from ptsharp.integrator import IntegratorConfig, trace, trace_compacted_static
from ptsharp.scene import SceneData


def render_shard(scene: SceneData, camera: Camera, cfg: IntegratorConfig,
                 key, dpi, spi, width: int, height: int, rows_per: int,
                 spp_per: int, use_tape: bool = False,
                 compacted: bool = False):
    """One (dp, sp) shard of `render_image_sharded`: rows
    [dpi * rows_per, (dpi + 1) * rows_per) at spp_per samples, from the
    key folded with dpi and then spi. Returns the shard's (rows_per,
    width, 3) sample mean. Also callable outside shard_map with integer
    indices, to replay a mesh render on one device."""
    lkey = jax.random.fold_in(jax.random.fold_in(key, dpi), spi)
    row0 = dpi * rows_per
    ys = row0 + jnp.arange(rows_per)
    xs = jnp.arange(width)
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    pix_x = jnp.broadcast_to(xx[None], (spp_per, rows_per, width)).reshape(-1)
    pix_y = jnp.broadcast_to(yy[None], (spp_per, rows_per, width)).reshape(-1)
    r = pix_x.shape[0]
    kj, kt = jax.random.split(lkey)
    ju, jv = jax.random.uniform(kj, (2, r))
    org, dirn = camera.cast_rays(pix_x, pix_y, width, height, ju, jv)
    if use_tape:
        from ptsharp.tape import trace_tape_radiance

        result = trace_tape_radiance(scene, cfg, org, dirn, kt)
    elif compacted:
        result = trace_compacted_static(scene, cfg, org, dirn, kt)
    else:
        result = trace(scene, cfg, org, dirn, kt)
    return jnp.mean(
        result.radiance.reshape(spp_per, rows_per, width, 3), axis=0
    )


def render_image_sharded(
    scene: SceneData,
    camera: Camera,
    cfg: IntegratorConfig,
    key,
    width: int,
    height: int,
    spp: int,
    mesh: Mesh,
    use_tape: bool = False,
    compacted: bool = False,
):
    """Mean-radiance render (H, W, 3) sharded rows x samples over the mesh.
    height must divide by mesh dp size, spp by sp size. Each shard draws
    from the key folded with its own dp and then sp index (render_shard).

    compacted: trace each shard with the sync-free wavefront compaction
    of the renderer and bench (integrator.trace_compacted_static).

    use_tape: route each shard's trace through the analytic tape backward
    (tape.py custom_vjp) — same primal, no AD through the bounce chain;
    shard_map's transpose still psums the replicated-param cotangents
    over the mesh."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    assert height % dp == 0, f"height {height} % dp {dp} != 0"
    assert spp % sp == 0, f"spp {spp} % sp {sp} != 0"
    rows_per = height // dp
    spp_per = spp // sp

    def local(scene, camera, key):
        partial = render_shard(
            scene, camera, cfg, key, jax.lax.axis_index("dp"),
            jax.lax.axis_index("sp"), width, height, rows_per, spp_per,
            use_tape=use_tape, compacted=compacted)
        # merge the sample shards across the "sp" devices
        return jax.lax.pmean(partial, "sp")

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P("dp", None, None),
        check_vma=False,
    )
    return fn(scene, camera, key)


def make_train_step(
    camera: Camera,
    cfg: IntegratorConfig,
    width: int,
    height: int,
    spp: int,
    mesh: Mesh,
    lr: float = 0.5,
    use_tape: bool = True,
):
    """Differentiable-render training step: SGD on the material color table
    toward a target image. The full step — forward wavefront, backward
    wavefront, gradient psum over the mesh — jits as one program; this is
    the `dryrun_multichip` payload and the pattern inverse-rendering users
    follow. use_tape (default) runs the backward through the analytic
    tape (tape.py) when the config supports it."""

    def loss_fn(colors, scene, key, target):
        mats = scene.materials._replace(color=colors)
        img = render_image_sharded(
            replace(scene, materials=mats), camera, cfg, key,
            width, height, spp, mesh, use_tape=use_tape,
        )
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(scene: SceneData, key, target):
        loss, g = jax.value_and_grad(loss_fn)(
            scene.materials.color, scene, key, target
        )
        new_colors = jnp.clip(scene.materials.color - lr * g, 0.0, 1.0)
        new_scene = replace(
            scene, materials=scene.materials._replace(color=new_colors)
        )
        return new_scene, loss

    return step
