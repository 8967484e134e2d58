"""Stage timing for a bench scene on the default device.

Times closest_hit / hit_info / NEE / full trace / RNG separately on one
wavefront, each to `block_until_ready`, so optimization targets the real
bottleneck. Prints the device (platform, kind, card name and power limit)
first; the times are that device's. Run on the GPU:
    python scripts/profile_stages.py [n_rays_log2] [scene]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ptsharp import examples, platform  # noqa: E402
from ptsharp.integrator import sample_lights, trace  # noqa: E402
from ptsharp.intersect import closest_hit, hit_info  # noqa: E402


def bench(name, fn, *args, iters=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
        jax.block_until_ready(out)
    dt = (time.time() - t0) / iters
    print(f"{name:28s} {dt * 1e3:8.2f} ms", flush=True)
    return dt


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    name = sys.argv[2] if len(sys.argv) > 2 else "cornell"
    platform.enable_compile_cache()
    print(json.dumps({"device": platform.device_summary()}))
    r = 1 << n
    scene, cam, _rcfg, icfg = examples.build(name)
    key = jax.random.PRNGKey(0)
    xs = jnp.arange(r, dtype=jnp.int32)
    ju, jv = jax.random.uniform(key, (2, r))
    org, dirn = cam.cast_rays(xs % 1920, (xs // 1920) % 1080, 1920, 1080, ju, jv)

    print(f"scene: {name}, rays: {r}")
    f_hit = jax.jit(lambda o, d: closest_hit(scene, o, d).t)
    bench("closest_hit", f_hit, org, dirn)

    def hitinfo_fn(o, d):
        h = closest_hit(scene, o, d)
        return hit_info(scene, o, d, h).normal

    bench("closest_hit+info", jax.jit(hitinfo_fn), org, dirn)

    def nee_fn(o, d, k):
        h = closest_hit(scene, o, d)
        info = hit_info(scene, o, d, h)
        dl, _ = sample_lights(scene, icfg, info.position, info.normal, k)
        return dl

    bench("hit+info+nee", jax.jit(nee_fn), org, dirn, key)

    def trace_fn(o, d, k):
        res = trace(scene, icfg, o, d, k)
        return res.radiance, res.rays_traced

    f_tr = jax.jit(trace_fn)
    t_tr = bench(f"full trace ({icfg.max_bounces} bounces)", f_tr, org, dirn,
                 key)
    traced = int(f_tr(org, dirn, key)[1])

    # RNG cost probe: 10 uniform draws over the wavefront
    def rng_fn(k):
        ks = jax.random.split(k, 10)
        return sum(jax.random.uniform(kk, (r,)) for kk in ks)

    bench("10x uniform draws", jax.jit(rng_fn), key)
    print(f"\nfull trace: {traced} rays traced, "
          f"{traced / t_tr / 1e6:.1f} Mrays/s")


if __name__ == "__main__":
    main()
