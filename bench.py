"""Benchmark harness: rays traced per second at 1080p, on the GPU.

Prints one JSON line per metric; every row names the device it ran on
(platform, kind, count, and the card's name and power limit):
  {"metric": "Mrays_per_s_per_chip_cornell_1080p", "value": N,
   "unit": "Mrays/s", "shape": ..., "runs": [...], "device": {...}}

Cells:
  cornell        BASELINE config #2 (area-light NEE, specular/refractive
                 spheres); analytic primitives only. 1M-ray chunks.
  bunny          BASELINE config #3: 81,920-triangle textured mesh, full
                 trace with NEE over 256k-ray compacted wavefronts.
  dragon_hd      1,310,720-triangle mesh, same full trace.
  fwd_bwd        forward + tape backward of the mean image luminance
                 w.r.t. the material table (the inverse-rendering step).
  closest_hit    coherent closest-hit on 1M Morton-ordered primaries of
                 dragon_hd: the raw traversal rate.

The benchmark runs only on a GPU and exits non-zero if any metric failed.
Run: python bench.py
"""

from __future__ import annotations

import functools
import json
import sys
import time
from dataclasses import replace

import jax
import jax.numpy as jnp


def _log_builder(scene_name):
    """Record which BVH builder produced this scene's tables ("sah" from
    the native binned-SAH builder, "morton" from the Python fallback).
    Returns the last builder's name."""
    from ptsharp.accel import bvh as bvh_mod

    print(json.dumps({
        "note": "bvh_builder", "scene": scene_name,
        "last": bvh_mod.last_builder,
        "counts": dict(bvh_mod.build_counts),
    }), file=sys.stderr)
    return bvh_mod.last_builder


def build(name, **scene_kw):
    """examples.build, logging the BVH builder. Mesh scenes take the
    traversal scene.build picks for the backend (the per-lane kernel on
    the GPU)."""
    from ptsharp import examples

    scene, cam, rcfg, icfg = examples.build(name, **scene_kw)
    _log_builder(name)
    return scene, cam, rcfg, icfg


def _pixel_chunk(ci, pix_per_chunk, width, height):
    n_pixels = width * height
    start = (ci * pix_per_chunk) % n_pixels
    xs = (start + jnp.arange(pix_per_chunk, dtype=jnp.int32)) % n_pixels
    return xs % width, xs // width


def _morton_pixel_order(width, height):
    """Pixel indices in 2D-Morton order: every traversal chunk covers a
    compact pixel block instead of a thin scanline strip."""
    import numpy as np

    x = np.arange(width, dtype=np.uint64)[None, :]
    y = np.arange(height, dtype=np.uint64)[:, None]

    def ex(v):
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    key = (ex(x) | (ex(y) << np.uint64(1))).reshape(-1)
    return jnp.asarray(np.argsort(key, kind="stable").astype(np.int32))


def run_scene(name, width=1920, height=1080, spp=64, max_measured_chunks=16,
              shift=20, split_raygen=False, compacted=False, built=None,
              **scene_kw):
    """Full-trace Mrays/s (every traced ray counted, shadow rays
    included) over `max_measured_chunks` wavefronts of 2**shift primaries.
    `built` reuses an (scene, cam, rcfg, icfg) tuple from `build`."""
    from ptsharp.integrator import trace, trace_compacted_static

    scene, cam, _rcfg, icfg = built or build(name, **scene_kw)
    tracer = trace_compacted_static if compacted else trace
    pix_per_chunk = 1 << shift

    # Small scenes are closure constants, which XLA can constant-fold;
    # scenes over 48 MB ride as traced arguments so their tables are not
    # embedded in the compiled program. Whether either choice still pays
    # is ROADMAP Queue 1 item 7.
    scene_bytes = sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(scene)
        if hasattr(x, "size"))
    scene_as_arg = scene_bytes > 48 * 1024 * 1024
    if split_raygen:
        # ray generation compiled as its own program (ROADMAP Queue 1
        # item 7 decides whether fusing it into the trace pays)
        morder = _morton_pixel_order(width, height)

        @jax.jit
        def gen(key, ci):
            kj, kt = jax.random.split(key)
            start = (ci * pix_per_chunk) % (width * height)
            xs = (start + jnp.arange(pix_per_chunk, dtype=jnp.int32)) \
                % (width * height)
            xs = morder[xs]
            px, py = xs % width, xs // width
            ju, jv = jax.random.uniform(kj, (2, pix_per_chunk))
            org, dirn = cam.cast_rays(px, py, width, height, ju, jv)
            return org, dirn, kt

        if scene_as_arg:
            @jax.jit
            def tr(scn, org, dirn, kt):
                result = tracer(scn, icfg, org, dirn, kt)
                return jnp.sum(result.radiance), result.rays_traced

            def render_chunk(key, ci):
                org, dirn, kt = gen(key, jnp.int32(ci))
                return tr(scene, org, dirn, kt)
        else:
            @jax.jit
            def tr(org, dirn, kt):
                result = tracer(scene, icfg, org, dirn, kt)
                return jnp.sum(result.radiance), result.rays_traced

            def render_chunk(key, ci):
                org, dirn, kt = gen(key, jnp.int32(ci))
                return tr(org, dirn, kt)
    else:
        def _chunk_rays(key, ci):
            kj, kt = jax.random.split(key)
            start = (ci * pix_per_chunk) % (width * height)
            xs = (start + jnp.arange(pix_per_chunk, dtype=jnp.int32)) \
                % (width * height)
            px, py = xs % width, xs // width
            ju, jv = jax.random.uniform(kj, (2, pix_per_chunk))
            org, dirn = cam.cast_rays(px, py, width, height, ju, jv)
            return org, dirn, kt

        if scene_as_arg:
            @jax.jit
            def _render_chunk(scn, key, ci):
                org, dirn, kt = _chunk_rays(key, ci)
                result = tracer(scn, icfg, org, dirn, kt)
                return jnp.sum(result.radiance), result.rays_traced

            def render_chunk(key, ci):
                return _render_chunk(scene, key, ci)
        else:
            @jax.jit
            def render_chunk(key, ci):
                org, dirn, kt = _chunk_rays(key, ci)
                result = tracer(scene, icfg, org, dirn, kt)
                return jnp.sum(result.radiance), result.rays_traced

    out = render_chunk(jax.random.PRNGKey(999), 0)
    jax.block_until_ready(out)

    total_rays_primary = width * height * spp
    n_chunks = max(1, total_rays_primary // pix_per_chunk)
    measured = min(n_chunks, max_measured_chunks)
    t0 = time.time()
    outs = []
    for i in range(measured):
        _s, traced = render_chunk(jax.random.PRNGKey(i), i)
        outs.append(traced)
    total_traced = sum(int(t) for t in outs)  # blocks once at the end
    dt = time.time() - t0
    return total_traced / dt / 1e6


def run_grad(width=1920, height=1080, chunks=2, mode="tape"):
    """Forward+backward Mrays/s: gradient of the mean image luminance w.r.t.
    the material table (the differentiable train-step shape of
    parallel/shard.py). 1M-ray chunks dispatched without blocking.

    mode="tape": analytic tape backward (tape.py custom_vjp), which replays
    a few scalars per ray and depth instead of re-running traversal and
    shading through AD. mode="ad": AD through the compacted trace."""
    from ptsharp import examples
    from ptsharp.integrator import trace_compacted_static
    from ptsharp.tape import trace_tape_radiance

    scene, cam, _rcfg, icfg = examples.build("cornell")
    pix_per_chunk = 1 << 20
    tracer = trace_tape_radiance if mode == "tape" else trace_compacted_static

    def loss_fn(colors, key, pix_x, pix_y):
        mats = scene.materials._replace(color=colors)
        s = replace(scene, materials=mats)
        r = pix_x.shape[0]
        kj, kt = jax.random.split(key)
        ju, jv = jax.random.uniform(kj, (2, r))
        org, dirn = cam.cast_rays(pix_x, pix_y, width, height, ju, jv)
        result = tracer(s, icfg, org, dirn, kt)
        return jnp.mean(result.radiance), result.rays_traced

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    px0, py0 = _pixel_chunk(0, pix_per_chunk, width, height)
    out = grad_fn(scene.materials.color, jax.random.PRNGKey(99), px0, py0)
    jax.block_until_ready(out)

    t0 = time.time()
    outs = []
    for i in range(chunks):
        px, py = _pixel_chunk(i, pix_per_chunk, width, height)
        _g, traced = grad_fn(scene.materials.color, jax.random.PRNGKey(i), px, py)
        outs.append(traced)
    total = sum(int(t) for t in outs)
    dt = time.time() - t0
    # rays_traced counts forward rays; backward replays them, so report
    # forward-equivalent throughput of the fused fwd+bwd step
    return total / dt / 1e6


def primary_rays(cam, r, ci, w=1920, h=1080, seed=7):
    """Chunk `ci` of `r` Morton-ordered jittered primaries at w x h."""
    morder = _morton_pixel_order(w, h)

    @jax.jit
    def gen(ci):
        start = (ci * r) % (w * h)
        xs = morder[(start + jnp.arange(r, dtype=jnp.int32)) % (w * h)]
        px, py = xs % w, xs // w
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ci)
        ju, jv = jax.random.uniform(key, (2, r))
        return cam.cast_rays(px, py, w, h, ju, jv)

    return gen(jnp.int32(ci))


def run_closest_hit(name, r=1 << 20, chunks=4, built=None, **scene_kw):
    """Coherent closest-hit throughput (Morton-ordered primaries): the raw
    traversal rate for meshes whose full trace would swamp the budget."""
    from ptsharp.intersect import closest_hit

    scene, cam, _rcfg, _icfg = built or build(name, **scene_kw)

    # the scene rides as a traced argument: large tables stay out of the
    # compiled program
    @jax.jit
    def ch(scn, org, dirn):
        hit = closest_hit(scn, org, dirn)
        return jnp.sum(hit.t * (hit.t < 1e9))

    rays = [primary_rays(cam, r, i) for i in range(chunks)]
    jax.block_until_ready(rays)
    out = ch(scene, *rays[0])
    jax.block_until_ready(out)

    # correctness gate: a miscompiled fast path must never record a
    # number — compare a 4096-ray sample against the XLA wide walk
    if scene.intersector != "wide":
        ref_scene = replace(scene, intersector="wide")
        o_s, d_s = (rays[0][0][:4096], rays[0][1][:4096])
        t_fast = closest_hit(scene, o_s, d_s).t
        t_ref = closest_hit(ref_scene, o_s, d_s).t
        ok = jnp.mean((jnp.abs(t_fast - t_ref) < 1e-3).astype(jnp.float32))
        if float(ok) < 0.999:
            raise RuntimeError(
                f"{name}: fast intersector disagrees with wide walk on "
                f"{(1 - float(ok)) * 100:.2f}% of sample rays")
    t0 = time.time()
    outs = [ch(scene, *c) for c in rays]
    jax.block_until_ready(outs)
    dt = time.time() - t0
    return chunks * r / dt / 1e6


def traversal_parity(built, r=1 << 20):
    """The per-lane kernel against the XLA wide walk on the same r
    Morton-ordered primaries. Compiled on the GPU, FMA contraction can flip
    ties on shared edges, so: t within 1e-4 relative where both hit, and
    the same primitive on >= 99.9% of lanes."""
    import numpy as np

    from ptsharp.intersect import closest_hit

    scene, cam, _rc, _ic = built
    org, dirn = primary_rays(cam, r, 0)
    f = jax.jit(closest_hit)
    ref = f(replace(scene, intersector="wide"), org, dirn)
    got = f(replace(scene, intersector="pallas"), org, dirn)
    t_r, t_g = np.asarray(ref.t), np.asarray(got.t)
    both = (t_r < 1e9) & (t_g < 1e9)
    rel = np.abs(t_g - t_r)[both] / np.maximum(t_r[both], 1e-6)
    same = np.mean((np.asarray(ref.pindex) == np.asarray(got.pindex))
                   & (np.asarray(ref.ptype) == np.asarray(got.ptype)))
    t_rel_max = float(rel.max()) if rel.size else 0.0
    return {"rays": r, "hit_frac": float((t_r < 1e9).mean()),
            "t_rel_max": t_rel_max, "t_rel_bound": 1e-4,
            "slot_agree": float(same), "slot_agree_bound": 0.999,
            "ok": bool(t_rel_max < 1e-4 and same >= 0.999)}


def run_repeated(fn, repeats=3):
    """Run `fn` `repeats` times (compiles are cached after the first) and
    return the median with every run."""
    vals = sorted(fn() for _ in range(repeats))
    mid = len(vals) // 2
    med = vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])
    return med, vals


@functools.lru_cache(maxsize=None)
def built_once(name):
    """`build(name)`, once per scene for all repeats and cells."""
    return build(name)


def jobs():
    return [
        ("Mrays_per_s_per_chip_cornell_1080p", "cornell/1M",
         lambda: run_scene("cornell", built=built_once("cornell"))),
        ("Mrays_per_s_per_chip_bunny82k_1080p", "bunny/256k/compact",
         lambda: run_scene("bunny", shift=18, max_measured_chunks=8,
                           split_raygen=True, compacted=True,
                           built=built_once("bunny"))),
        ("Mrays_per_s_per_chip_dragon_full_trace", "dragon_hd/256k/compact",
         lambda: run_scene("dragon_hd", shift=18, max_measured_chunks=4,
                           split_raygen=True, compacted=True,
                           built=built_once("dragon_hd"))),
        ("Mrays_per_s_fwd_bwd_cornell", "grad/tape/1M",
         lambda: run_grad(mode="tape")),
        ("Mrays_per_s_closest_hit_dragon1p3M", "dragon_hd/1M",
         lambda: run_closest_hit("dragon_hd",
                                 built=built_once("dragon_hd"))),
    ]


def main():
    from ptsharp import platform

    platform.require_gpu()
    platform.enable_compile_cache()
    device = platform.device_summary()
    failed = False
    for metric, shape, fn in jobs():
        try:
            mrays, vals = run_repeated(fn)
        except Exception as e:  # noqa: BLE001 — reported, and the run fails
            failed = True
            row = {"metric": metric, "shape": shape,
                   "error": f"{type(e).__name__}: {str(e)[:300]}"}
        else:
            row = {
                "metric": metric,
                "value": mrays,
                "unit": "Mrays/s",
                "shape": shape,
                "runs": vals,
                "min": min(vals),
                "max": max(vals),
            }
        row["device"] = device
        print(json.dumps(row), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
