"""Scaling-efficiency harness: sharded render throughput on 1/2/4/8 virtual
CPU devices (SURVEY.md §5 distributed-backend row). Run:
python scripts/scaling_bench.py

Virtual CPU devices measure the *sharding overhead* (collectives, partition
bookkeeping) rather than real interconnect bandwidth — on CPU all "devices"
share the same silicon, so super-/sub-linear deviations are scheduling
artifacts. These are CPU numbers, never GPU ones; `python chip_smoke.py
--four-cards` runs the same sharded path on four cards.
"""

import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from ptsharp import examples
from ptsharp.parallel.distributed import global_mesh
from ptsharp.parallel.shard import render_image_sharded


def main():
    scene, cam, _r, icfg = examples.build("cornell")
    width, height, spp = 256, 256, 8

    rows = []
    base_rate = None
    for n in (1, 2, 4, 8):
        sp = 2 if n >= 2 else 1
        dp = n // sp
        mesh = global_mesh(dp=dp, sp=sp, devices=jax.devices()[:n])

        fn = jax.jit(
            lambda key: render_image_sharded(
                scene, cam, icfg, key, width, height, spp, mesh
            )
        )
        img = jax.block_until_ready(fn(jax.random.PRNGKey(0)))
        assert bool(jnp.isfinite(img).all())
        t0 = time.time()
        reps = 3
        for i in range(reps):
            img = fn(jax.random.PRNGKey(i))
        jax.block_until_ready(img)
        dt = (time.time() - t0) / reps
        prim = width * height * spp
        rate = prim / dt / 1e6
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n) * 100.0
        rows.append((n, dp, sp, dt, rate, eff))
        print(f"devices={n} (dp={dp},sp={sp})  {dt*1e3:8.1f} ms  "
              f"{rate:7.2f} Mprimary/s  efficiency {eff:5.1f}%", flush=True)

    print("\nMarkdown rows (virtual CPU devices):")
    for n, dp, sp, dt, rate, eff in rows:
        print(f"| {n} | ({dp}, {sp}) | {rate:.2f} | {eff:.0f}% |")


if __name__ == "__main__":
    main()
