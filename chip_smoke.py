"""Smoke test of the path tracer on the GPU: the main path, at full size,
through the entry points a user calls, with every kernel compiled for the
card and checked against its plain reference.

    python chip_smoke.py               # one card (all phases below)
    python chip_smoke.py --four-cards  # the sharded path on four cards only

One card, in order:
  gpu tests   the `gpu`-marked pytest cases (compiled traversal kernels
              against the XLA walk), in a child process that exits before
              this process opens the card
  device      JAX's default device must be a GPU; never carry on on the CPU
  reference   160x90 at 16 spp, same key, on the GPU and on the host CPU
              backend, for Cornell and for a mesh scene whose shadow rays
              take the any-hit kernel (both with Russian roulette); image
              mean and per-pixel RMSE within bounds derived from the CPU
              film's own per-pixel standard error
  full size   Renderer.iterative_render, 3 passes of 2 spp at 1920x1080, on
              Cornell and on bunny (81,920 triangles); trace_compacted_static
              over one 256k-ray wavefront of dragon_hd (1,310,720 triangles);
              closest-hit on 1M Morton-ordered primaries of bunny and
              dragon_hd; 3 steps of parallel.shard.make_train_step with the
              tape backward at 1080p on a one-card mesh
  parity      the traversal kernel against the XLA wide walk on the same 1M
              rays of bunny and dragon_hd
  gradients   tape gradients against AD gradients of 2,048 Cornell rays,
              with f32 matrix products at full precision, on the card and
              on the host CPU

Four cards: a (dp=2, sp=2) mesh renders Cornell at 1080p and 4 spp and runs
3 train steps at 480x270 and 4 spp; a one-card replay of the four shards
(each from the key folded with its own dp and sp index) must give the same
image and losses.

Mesh scenes must be built by the native SAH builder, and their closest-hit
and shadow rays must go through the Pallas traversal kernel, which
scene.build picks on the GPU. Any failed check raises: the script then exits
non-zero and prints no result line. The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def run_gpu_tests():
    """The gpu-marked tests, in a child process, before this process
    opens the card (a JAX process reserves most of the card's memory)."""
    env = dict(os.environ, PTSHARP_TEST_ON_GPU="1")
    cmd = [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
           "no:cacheprovider", "tests/"]
    t0 = time.time()
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=900)
    tail = out.stdout.strip().splitlines()[-1:] or [""]
    log("gpu_tests", rc=out.returncode, summary=tail[0],
        seconds=time.time() - t0)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
    check(out.returncode == 0, "gpu-marked tests failed")
    check(" passed" in tail[0] and "skipped" not in tail[0],
          f"gpu-marked tests did not all run on the card: {tail[0]}")


def require_devices(n):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX's default device is {devs[0].platform!r}, not a GPU")
    check(len(devs) >= n, f"needs {n} GPUs, JAX found {len(devs)}")
    return devs


def mesh_builder(name, built):
    """The builder that made the last mesh BVH: must be the native SAH.
    The scene's mesh traversal must be the GPU kernel, which scene.build
    picks on the GPU."""
    from ptsharp.accel import bvh as bvh_mod

    b = {"last": bvh_mod.last_builder, "counts": dict(bvh_mod.build_counts)}
    check(b["last"] == "sah" and b["counts"]["morton"] == 0,
          f"{name}: BVH not built by the native SAH builder: {b}")
    check(built[0].intersector == "pallas",
          f"{name}: mesh traversal is {built[0].intersector!r}, not the "
          "GPU kernel")
    return b


def sample_image(scene, cam, icfg, key, w, h, spp):
    """(spp, h, w, 3) per-sample radiance of a w x h render."""
    import jax
    import jax.numpy as jnp

    from ptsharp.integrator import trace

    r = w * h * spp
    idx = jnp.arange(r, dtype=jnp.int32)
    kj, kt = jax.random.split(key)
    ju, jv = jax.random.uniform(kj, (2, r))
    org, dirn = cam.cast_rays(idx % w, (idx // w) % h, w, h, ju, jv)
    return trace(scene, icfg, org, dirn, kt).radiance.reshape(spp, h, w, 3)


def phase_reference(name, built, w=160, h=90, spp=16):
    """GPU render against the host-CPU render of the same frame and key;
    the CPU runs the XLA walk. Both sides draw the same random numbers, so
    only paths that float reordering sends another way diverge. The bounds
    come from the CPU film's per-pixel standard error se: a diverged pixel
    differs by ~sqrt(2) se, and at most 1% of pixels may diverge, so the
    RMSE bound is 2 * sqrt(0.01 * 2 * mean(se^2)); the image-mean bound is
    4 standard errors of the mean difference."""
    import jax
    import numpy as np

    scene, cam, _rc, icfg = built
    key = jax.random.PRNGKey(11)
    f = jax.jit(sample_image, static_argnums=(2, 4, 5, 6))
    gpu = np.asarray(f(scene, cam, icfg, key, w, h, spp))
    cpu_dev = jax.devices("cpu")[0]
    on_cpu = jax.device_put((replace(scene, intersector="wide"), cam, key),
                            cpu_dev)
    cpu = np.asarray(f(on_cpu[0], on_cpu[1], icfg, on_cpu[2], w, h, spp))
    img_g, img_c = gpu.mean(0), cpu.mean(0)
    se2 = cpu.var(0, ddof=1) / spp
    rmse = float(np.sqrt(np.mean((img_g - img_c) ** 2)))
    rmse_bound = float(2.0 * np.sqrt(0.01 * 2.0 * se2.mean()))
    mean_diff = float(abs(img_g.mean() - img_c.mean()))
    mean_bound = float(4.0 * np.sqrt(2.0 * se2.sum()) / se2.size)
    log("reference", scene=name, intersector=scene.intersector,
        anyhit_shadows=icfg.anyhit_shadows,
        russian_roulette=icfg.russian_roulette, size=f"{w}x{h}x{spp}",
        gpu_mean=float(img_g.mean()), cpu_mean=float(img_c.mean()),
        mean_diff=mean_diff, mean_bound=mean_bound, rmse=rmse,
        rmse_bound=rmse_bound)
    check(np.isfinite(gpu).all() and img_g.mean() > 0, f"{name}: GPU render")
    check(mean_diff <= mean_bound, f"{name}: image means differ")
    check(rmse <= rmse_bound, f"{name}: per-pixel RMSE too large")


def phase_progressive(name, built, builder=None, w=1920, h=1080, spp=2,
                      passes=3):
    """Renderer.iterative_render: `passes` progressive passes of `spp`."""
    import jax
    import numpy as np

    from ptsharp.renderer import RenderConfig, Renderer

    scene, cam, _rc, icfg = built
    r = Renderer(scene, cam, RenderConfig(width=w, height=h, spp=spp), icfg)
    t0 = time.time()
    film = r.iterative_render(passes, key=jax.random.PRNGKey(1))
    jax.block_until_ready(film.mean)
    total_s = time.time() - t0  # compilation included
    rays = r.rays_traced
    # one more pass, warm, for the rate
    t0 = time.time()
    jax.block_until_ready(r.render(key=jax.random.PRNGKey(2)).mean)
    warm_s = time.time() - t0
    warm_rays = r.rays_traced - rays
    img = np.asarray(film.mean)
    n = np.asarray(film.n)
    primaries = w * h * spp * passes
    log("progressive", scene=name, intersector=scene.intersector,
        builder=builder, size=f"{w}x{h}", passes=passes, spp=spp,
        rays_traced=rays, seconds_with_compile=total_s,
        mrays_s_warm_pass=warm_rays / warm_s / 1e6,
        image_mean=float(img.mean()))
    check(np.isfinite(img).all() and img.mean() > 0, f"{name}: image")
    check(np.all(n == spp * passes), f"{name}: samples per pixel")
    # every primary is traced; each bounce traces at most one continuation
    # and one shadow ray per lane
    check(primaries <= rays <= primaries * 2 * (icfg.max_bounces + 1),
          f"{name}: rays_traced {rays} vs {primaries} primaries")


def phase_wavefront(name, built, builder, r=1 << 18):
    """trace_compacted_static over one wavefront of r Morton primaries."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from ptsharp.integrator import trace_compacted_static

    scene, cam, _rc, icfg = built
    org, dirn = bench.primary_rays(cam, r, 0)

    @jax.jit
    def run(scn, o, d, k):
        res = trace_compacted_static(scn, icfg, o, d, k)
        return res.radiance, res.rays_traced

    key = jax.random.PRNGKey(2)
    rad, rays = run(scene, org, dirn, key)
    jax.block_until_ready(rad)
    t0 = time.time()
    rad, rays = run(scene, org, dirn, jax.random.PRNGKey(3))
    rays = int(rays)
    dt = time.time() - t0
    rad = np.asarray(rad)
    log("wavefront", scene=name, intersector=scene.intersector,
        builder=builder, rays=r, rays_traced=rays, mrays_s=rays / dt / 1e6,
        radiance_mean=float(rad.mean()))
    check(rad.shape == (r, 3) and np.isfinite(rad).all(), f"{name}: radiance")
    check(float(jnp.min(rad)) >= 0 and rad.mean() > 0, f"{name}: black")
    check(r <= rays <= r * 2 * (icfg.max_bounces + 1),
          f"{name}: rays_traced {rays}")


def phase_closest_hit_and_parity(name, built, builder, r=1 << 20):
    import bench

    mrays = bench.run_closest_hit(name, r=r, built=built)
    log("closest_hit", scene=name, intersector=built[0].intersector,
        builder=builder, rays=r, mrays_s=mrays)
    par = bench.traversal_parity(built, r=r)
    log("parity", scene=name, **par)
    check(par["ok"], f"{name}: kernel disagrees with the XLA walk")


def phase_train(w=1920, h=1080, spp=2, steps=3):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ptsharp import examples
    from ptsharp.parallel.shard import make_train_step

    scene, cam, _rc, icfg = examples.build("cornell")
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    step = make_train_step(cam, icfg, w, h, spp, mesh, lr=0.1,
                           use_tape=True)
    target = jnp.zeros((h, w, 3), jnp.float32)
    key = jax.random.PRNGKey(4)
    losses = []
    t0 = time.time()
    for i in range(steps):
        if i == 1:
            t0 = time.time()
        scene, loss = step(scene, key, target)
        losses.append(float(loss))
    dt = time.time() - t0
    log("train_step", size=f"{w}x{h}x{spp}", mesh="1x1", losses=losses,
        mprimary_s_fwd_bwd=w * h * spp * (steps - 1) / dt / 1e6)
    check(all(np.isfinite(losses)), "train loss not finite")
    check(losses[-1] < losses[0], "train loss did not fall")


def tape_and_ad_gradients(device, n):
    """Tape and AD gradients of the mean radiance of n Cornell rays
    w.r.t. material color and emittance, computed on `device` with f32
    matrix products at full precision."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptsharp import examples
    from ptsharp.integrator import trace
    from ptsharp.tape import trace_tape_radiance

    scene, cam, _rc, icfg = examples.build("cornell")
    scene, cam, key = jax.device_put((scene, cam, jax.random.PRNGKey(5)),
                                     device)
    out = {}
    with jax.default_device(device), jax.default_matmul_precision("highest"):
        xs = jnp.arange(n, dtype=jnp.int32)
        ju, jv = jax.random.uniform(key, (2, n))
        org, dirn = cam.cast_rays(xs % 640, (xs // 640) % 360, 640, 360,
                                  ju, jv)
        for field in ("color", "emittance"):
            def plug(x, field=field):
                return replace(scene, materials=scene.materials._replace(
                    **{field: x}))

            def la(x, plug=plug):
                return jnp.mean(trace(plug(x), icfg, org, dirn, key).radiance)

            def lt(x, plug=plug):
                return jnp.mean(trace_tape_radiance(
                    plug(x), icfg, org, dirn, key).radiance)

            x0 = getattr(scene.materials, field)
            out[field] = (np.asarray(jax.jit(jax.grad(la))(x0)),
                          np.asarray(jax.jit(jax.grad(lt))(x0)))
    return out


def phase_gradients(n=2048):
    """tests/test_tape.py's check, on the card: tape vs AD gradients of n
    Cornell rays (rtol 1e-3, atol 1e-7: two differentiation orders of the
    same f32 sums). The host CPU runs the same check as a second witness.
    n = 2,048 is the size whose AD gradient once failed to launch on the
    H100 (see vec.dot)."""
    import jax
    import numpy as np

    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        out = {}
        for field, (ga, gt) in tape_and_ad_gradients(dev, n).items():
            err = np.abs(ga - gt) - (1e-7 + 1e-3 * np.abs(gt))
            out[field] = {"max_abs_diff": float(np.abs(ga - gt).max()),
                          "max_excess_over_bound": float(err.max())}
            check(np.isfinite(ga).all() and np.abs(ga).max() > 0,
                  f"{dev.platform}: AD gradient w.r.t. {field}")
            check(err.max() <= 0,
                  f"{dev.platform}: tape vs AD gradient w.r.t. {field}")
        log("gradients", device=dev.platform, rays=n,
            bound="rtol 1e-3, atol 1e-7", **out)


def phase_four_cards(w=1920, h=1080, spp=4, steps=3, lr=0.1, train_w=480,
                     train_h=270):
    """(dp=2, sp=2) render at w x h, and train steps at train_w x train_h
    (the same spp), against a one-card replay.

    Tolerances: both sides run the same per-shard code on the same kind of
    card, but compiled in different programs, so float contraction may
    differ and a few chaotic paths may diverge. Image: mean within 1e-5
    relative and at least 99.9% of values within 1e-3 relative (+1e-5
    absolute). Loss: within 1e-5 relative at every step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ptsharp import examples
    from ptsharp.parallel.shard import (
        make_train_step, render_image_sharded, render_shard,
    )

    devs = require_devices(4)
    mesh = Mesh(np.asarray(devs[:4]).reshape(2, 2), ("dp", "sp"))
    scene, cam, _rc, icfg = examples.build("cornell")
    dp, sp = 2, 2
    rows_per, spp_per = h // dp, spp // sp
    key = jax.random.PRNGKey(21)

    t0 = time.time()
    img4 = render_image_sharded(scene, cam, icfg, key, w, h, spp, mesh)
    img4 = np.asarray(img4)
    t_mesh = time.time() - t0

    def replay_image(scn, k, use_tape):
        @jax.jit
        def shard(scn, k, dpi, spi):
            return render_shard(scn, cam, icfg, k, dpi, spi, w, h, rows_per,
                                spp_per, use_tape=use_tape)

        rows = []
        for dpi in range(dp):
            parts = [shard(scn, k, jnp.int32(dpi), jnp.int32(spi))
                     for spi in range(sp)]
            rows.append(sum(parts) / sp)
        return jnp.concatenate(rows, axis=0)

    with jax.default_device(devs[0]):
        img1 = np.asarray(replay_image(scene, key, False))
    rel = np.abs(img4 - img1) / (np.abs(img1) + 1e-5)
    frac_close = float(np.mean(rel <= 1e-3))
    mean_rel = float(abs(img4.mean() - img1.mean()) / img1.mean())
    log("four_cards_render", size=f"{w}x{h}x{spp}", mesh="dp=2,sp=2",
        seconds=t_mesh, mean_4=float(img4.mean()), mean_1=float(img1.mean()),
        mean_rel_diff=mean_rel, mean_rel_bound=1e-5,
        frac_within_rel_1e_3=frac_close, frac_bound=0.999,
        max_abs_diff=float(np.abs(img4 - img1).max()))
    check(np.isfinite(img4).all() and img4.mean() > 0, "4-card image")
    check(mean_rel <= 1e-5, "4-card image mean vs replay")
    check(frac_close >= 0.999, "4-card image vs replay")

    w, h = train_w, train_h
    rows_per = h // dp
    step4 = make_train_step(cam, icfg, w, h, spp, mesh, lr=lr, use_tape=True)
    target = jnp.full((h, w, 3), 0.05, jnp.float32)
    scn4, losses4 = scene, []
    t0 = time.time()
    for i in range(steps):
        scn4, loss = step4(scn4, jax.random.fold_in(key, i), target)
        losses4.append(float(loss))
    t_train = time.time() - t0

    def loss1(colors, scn, k):
        s = replace(scn, materials=scn.materials._replace(color=colors))
        return jnp.mean((replay_image(s, k, True) - target) ** 2)

    vg = jax.jit(jax.value_and_grad(loss1))
    scn1, losses1 = scene, []
    with jax.default_device(devs[0]):
        for i in range(steps):
            loss, g = vg(scn1.materials.color, scn1, jax.random.fold_in(key, i))
            colors = jnp.clip(scn1.materials.color - lr * g, 0.0, 1.0)
            scn1 = replace(scn1,
                           materials=scn1.materials._replace(color=colors))
            losses1.append(float(loss))
    rel_l = [abs(a - b) / abs(b) for a, b in zip(losses4, losses1)]
    log("four_cards_train", size=f"{w}x{h}x{spp}", steps=steps,
        losses_4=losses4, losses_1=losses1,
        loss_rel_diff=rel_l, loss_rel_bound=1e-5, seconds=t_train)
    check(all(np.isfinite(losses4)), "4-card losses")
    check(max(rel_l) <= 1e-5, "4-card losses vs replay")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the (dp=2, sp=2) four-card path and its "
                         "one-card replay")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.chdir(REPO)

    from ptsharp import platform

    card = platform.gpu_name_and_power_limit()
    check(card is not None, "nvidia-smi finds no GPU")
    print(card, flush=True)
    if not args.four_cards:
        run_gpu_tests()

    import jax

    platform.enable_compile_cache()
    devs = require_devices(4 if args.four_cards else 1)
    log("device", platform=devs[0].platform, kind=devs[0].device_kind,
        count=len(devs), jax=jax.__version__)
    t_start = time.time()
    if args.four_cards:
        phase_four_cards()
    else:
        import bench
        from ptsharp import examples

        cornell = bench.build("cornell")
        phase_reference("cornell", cornell)
        # a mesh scene whose shadow rays take the any-hit kernel, with
        # Russian roulette on
        mesh = examples.build("mesh")
        mesh_builder("mesh", mesh)
        mesh = mesh[:3] + (replace(mesh[3], russian_roulette=True),)
        phase_reference("mesh", mesh)
        phase_progressive("cornell", cornell)
        bunny = bench.build("bunny")
        bunny_sah = mesh_builder("bunny", bunny)
        phase_progressive("bunny", bunny, bunny_sah)
        phase_closest_hit_and_parity("bunny", bunny, bunny_sah)
        del bunny
        dragon = bench.build("dragon_hd")
        dragon_sah = mesh_builder("dragon_hd", dragon)
        phase_wavefront("dragon_hd", dragon, dragon_sah)
        phase_closest_hit_and_parity("dragon_hd", dragon, dragon_sah)
        del dragon
        phase_train()
        phase_gradients()
    log("done", seconds=time.time() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
