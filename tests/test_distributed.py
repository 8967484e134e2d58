"""Real multi-process jax.distributed exercise (SURVEY.md §5 distributed
backend row): two CPU subprocesses join a localhost coordinator via
ptsharp.parallel.distributed.initialize, build the global (dp, sp)
mesh, run one sharded render + train step, and must agree on the loss.

This is the cross-host path the single-process shard_map tests cannot
cover: Gloo collectives, per-process addressable shards, replicated scene
inputs on a multi-controller mesh.
"""

import socket
import subprocess
import sys
import textwrap

import pytest

_CHILD = textwrap.dedent("""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
port, pid = sys.argv[1], int(sys.argv[2])

from ptsharp.parallel import distributed as dist
dist.initialize(coordinator_address=f"localhost:{port}",
                num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, len(jax.devices())

import jax.numpy as jnp
from ptsharp.camera import Camera
from ptsharp.geometry.mesh import cube_mesh
from ptsharp.integrator import IntegratorConfig
from ptsharp.materials import diffuse_material, light_material
from ptsharp.parallel.shard import make_train_step, render_image_sharded
from ptsharp.scene import SceneBuilder

mesh = dist.global_mesh(dp=2, sp=2)
b = SceneBuilder()
b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
b.add_mesh(cube_mesh([-0.5, 0, -0.5], [0.5, 1, 0.5]),
           diffuse_material([0.6, 0.3, 0.2]))
b.add_sphere([2, 4, -2], 1.0, light_material([1, 1, 1], 8.0))
scene = b.build(leaf_size=4)
cam = Camera.look_at([0, 1.5, -4], [0, 0.5, 0], [0, 1, 0], 40.0)
icfg = IntegratorConfig(max_bounces=2)

img = render_image_sharded(scene, cam, icfg, jax.random.PRNGKey(0),
                           8, 8, 4, mesh)
jax.block_until_ready(img)

step = make_train_step(cam, icfg, 8, 8, 4, mesh, lr=0.1)
target = jnp.zeros((8, 8, 3), jnp.float32)
new_scene, loss = step(scene, jax.random.PRNGKey(1), target)
assert bool(jnp.isfinite(loss))
print(f"LOSS {float(loss):.9f}", flush=True)
""")


@pytest.mark.slow
def test_two_process_distributed_train_step():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(port), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("2-process distributed run timed out")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
    losses = [
        line.split()[1]
        for out in outs for line in out.splitlines() if line.startswith("LOSS")
    ]
    assert len(losses) == 2, outs
    assert losses[0] == losses[1], losses
