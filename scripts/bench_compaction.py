"""Compaction gain measurement: cornell with russian_roulette=True,
max_bounces=8, 1M-ray wavefront — trace vs trace_compacted wall-clock on
the default device (run it on the GPU; ROADMAP Queue 3 item 8)."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from ptsharp import examples
from ptsharp.integrator import IntegratorConfig, trace, trace_compacted

R = 1 << 20


def main():
    scene, cam, _r, _i = examples.build("cornell")
    icfg = IntegratorConfig(max_bounces=8, russian_roulette=True,
                            rr_start_depth=2)
    w, h = 1920, 1080
    xs = jnp.arange(R, dtype=jnp.int32)
    px, py = xs % w, (xs // w) % h
    key = jax.random.PRNGKey(0)
    kj, kt = jax.random.split(key)
    ju, jv = jax.random.uniform(kj, (2, R))
    org, dirn = cam.cast_rays(px, py, w, h, ju, jv)

    f_plain = jax.jit(lambda o, d, k: trace(scene, icfg, o, d, k))

    def run(f, label, reps=3):
        res = f(org, dirn, kt)
        tot = float(res.radiance.sum())  # sync
        best = 1e9
        for i in range(reps):
            t0 = time.time()
            res = f(org, dirn, jax.random.fold_in(kt, i))
            float(res.radiance.sum())
            best = min(best, time.time() - t0)
        rays = int(res.rays_traced)
        print(f"{label:16s} {best*1e3:8.1f} ms  "
              f"{rays/best/1e6:7.2f} Mrays/s (rays={rays})", flush=True)
        return best

    t_plain = run(f_plain, "trace")
    t_comp = run(
        lambda o, d, k: trace_compacted(scene, icfg, o, d, k), "compacted"
    )
    print(f"speedup x{t_plain / t_comp:.2f}")


if __name__ == "__main__":
    main()
