"""Render driver: progressive, adaptive, and firefly passes over the film.

Replaces reference Renderer.cs. Where the reference fans 32x32 sub-tile
Tasks onto a custom work-stealing scheduler (Renderer.cs:256-338,
WorkStealingScheduler.cs), this driver owns the whole image as device
arrays: each pass renders `spp` samples for every pixel in statically-sized
row chunks (one jitted wavefront per chunk — static tile ownership), and
variance-driven passes (adaptive, Renderer.cs:340-416; firefly,
Renderer.cs:418-468) run the same wavefront with per-pixel sample masks
instead of dynamic work queues. Welford film accumulation is deterministic
and order-independent, so chunks, passes, and (later) devices compose by
pure merges.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field, replace

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.camera import Camera
from ptsharp.core import color as colorlib
from ptsharp.core import filters
from ptsharp.film import Film, save_png
from ptsharp.integrator import IntegratorConfig, trace
from ptsharp.scene import SceneData


@dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 256
    spp: int = 4  # samples per pixel per progressive pass (Renderer.cs:42)
    stratified: bool = False  # stratified first-hit grid (Renderer.cs:231-254)
    adaptive_samples: int = 0  # max extra samples/pixel (Renderer.cs:26)
    adaptive_threshold: float = 1.0
    adaptive_exponent: float = 1.0
    firefly_samples: int = 0  # extra samples for firefly pixels
    firefly_threshold: float = 1.0
    filter: str = "box"  # pixel reconstruction filter (box/triangle/gaussian)
    max_rays_per_chunk: int = 1 << 21  # wavefront width bound (memory knob)
    # wavefront compaction (trace_compacted_static): after Russian roulette
    # culls the wavefront, survivors are reservoir-capped + Morton-packed
    # into statically scheduled smaller buffers for the tail depths — zero
    # host syncs (the schedule is fixed at trace time; overflow beyond a
    # cap is handled unbiasedly by throughput reweighting). Default ON;
    # it self-disables (falls back to plain trace) when RR is off or the
    # specular mode branches. Whether it pays on the GPU is ROADMAP
    # Queue 3 item 8.
    compaction: bool = True


class Renderer:
    """Stateless apart from the compiled-render cache; all image state
    lives in the Film the caller threads through."""

    def __init__(
        self,
        scene: SceneData,
        camera: Camera,
        config: RenderConfig,
        integrator: IntegratorConfig | None = None,
    ):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.integrator = integrator or IntegratorConfig()
        self._chunk_fn = None
        self.rays_traced = 0

    # -- internals ---------------------------------------------------------

    def _rows_per_chunk(self, spp: int) -> int:
        cfg = self.config
        rows = max(1, cfg.max_rays_per_chunk // max(1, cfg.width * spp))
        return int(min(rows, cfg.height))

    def _build_chunk_fn(self):
        cfg = self.config
        icfg = self.integrator

        def pixel_perm(row0, rows: int, w: int):
            """2D-Morton order of the chunk's pixels: neighbouring lanes
            then cover compact ~32x32 pixel blocks instead of scanline
            strips, so they walk the same BVH nodes."""
            ys = (row0 + jnp.arange(rows, dtype=jnp.uint32))[:, None]
            xs = jnp.arange(w, dtype=jnp.uint32)[None, :]

            def ex(v):
                v = (v | (v << 8)) & jnp.uint32(0x00FF00FF)
                v = (v | (v << 4)) & jnp.uint32(0x0F0F0F0F)
                v = (v | (v << 2)) & jnp.uint32(0x33333333)
                v = (v | (v << 1)) & jnp.uint32(0x55555555)
                return v

            mkey = ex(xs) | (ex(ys) << jnp.uint32(1))
            perm = jnp.argsort(mkey.reshape(-1))
            return perm, jnp.argsort(perm)

        def raygen(scene: SceneData, camera: Camera, key, row0, rows: int,
                   spp: int):
            w = cfg.width
            ys = row0 + jnp.arange(rows)
            xs = jnp.arange(w)
            yy, xx = jnp.meshgrid(ys, xs, indexing="ij")  # (rows, W)
            pix_x = jnp.broadcast_to(xx[None], (spp, rows, w)).reshape(-1)
            pix_y = jnp.broadcast_to(yy[None], (spp, rows, w)).reshape(-1)
            r = pix_x.shape[0]

            kj, kl, kt = jax.random.split(key, 3)
            ju, jv = jax.random.uniform(kj, (2, r))
            if cfg.stratified:
                n = max(1, int(np.sqrt(spp)))
                sidx = jnp.broadcast_to(
                    jnp.arange(spp)[:, None, None] % (n * n), (spp, rows, w)
                ).reshape(-1)
                iu = (sidx % n).astype(jnp.float32)
                iv = (sidx // n).astype(jnp.float32)
                ju = (iu + ju) / n
                jv = (iv + jv) / n
            lens_u, lens_v = jax.random.uniform(kl, (2, r))
            org, dirn = camera.cast_rays(
                pix_x, pix_y, cfg.width, cfg.height, ju, jv, lens_u, lens_v
            )
            n_strat = max(1, int(np.sqrt(spp))) if cfg.stratified else 1
            sidx2 = (
                jnp.broadcast_to(
                    jnp.arange(spp)[:, None, None] % (n_strat * n_strat),
                    (spp, rows, w),
                ).reshape(-1)
                if n_strat > 1
                else None
            )
            if scene.inst_inv.shape[0] > 0:  # static: mesh scenes only
                perm, inv = pixel_perm(row0, rows, w)

                def shuf(a):
                    s = a.reshape((spp, rows * w) + a.shape[1:])
                    return s[:, perm].reshape(a.shape)

                org, dirn = shuf(org), shuf(dirn)
                if sidx2 is not None:
                    sidx2 = shuf(sidx2)
            else:
                inv = None
            return org, dirn, kt, sidx2, ju, jv, inv

        def film_accumulate(result, ju, jv, rows: int, spp: int, weight_rows,
                            inv=None):
            w = cfg.width

            def unshuf(a):
                if inv is None:
                    return a
                s = a.reshape((spp, rows * w) + a.shape[1:])
                return s[:, inv].reshape(a.shape)

            radiance = unshuf(result.radiance).reshape(spp, rows, w, 3)
            albedo = unshuf(result.albedo).reshape(spp, rows, w, 3)
            normal = unshuf(result.normal).reshape(spp, rows, w, 3)
            chunk = Film.zeros(rows, w)
            if weight_rows is None:
                weight = jnp.ones((spp, rows, w), jnp.float32)
            else:
                weight = weight_rows
            if cfg.filter != filters.BOX:
                # reconstruction-filter weighting by subpixel offset
                # (TriangleFilter capability, BASELINE config #5)
                fw = filters.evaluate(cfg.filter, ju - 0.5, jv - 0.5)
                weight = weight * fw.reshape(spp, rows, w)
            chunk = chunk.add_batch(radiance, weight, albedo, normal)
            return chunk, result.rays_traced

        def render_chunk(scene: SceneData, camera: Camera, key, row0,
                         rows: int, spp: int, weight_rows):
            """Render `spp` samples for image rows [row0, row0+rows).
            weight_rows: (spp, rows, W) 0/1 mask for adaptive passes (or
            None). Returns per-chunk Film stats + ray count."""
            org, dirn, kt, sidx2, ju, jv, inv = raygen(
                scene, camera, key, row0, rows, spp
            )
            n_strat = max(1, int(np.sqrt(spp))) if cfg.stratified else 1
            result = trace(scene, icfg, org, dirn, kt, sidx2, n_strat)
            return film_accumulate(result, ju, jv, rows, spp, weight_rows,
                                   inv)

        self._chunk_fn = jax.jit(
            render_chunk, static_argnames=("rows", "spp"),
        )

        # compaction engages for naive-specular configs with a non-empty
        # reservoir schedule (round 5: RR is no longer required — env-miss
        # and emissive cuts kill lanes too, compaction_schedule docstring).
        # For any other shape, compacted_chunk would silently replace the
        # fully-jitted render_chunk with an un-jitted trace() fallback —
        # so the schedule is re-checked per chunk SHAPE (rows and spp are
        # static per call) and empty-schedule shapes route to the plain
        # jitted chunk fn.
        from ptsharp.integrator import compaction_schedule

        # "could it ever engage" probe at an unbounded width: empty means
        # the config can never compact (wrong specular mode, too shallow)
        # and the plain jitted chunk fn stays installed directly
        compaction_applies = bool(compaction_schedule(icfg, 1 << 30))
        if cfg.compaction and compaction_applies:
            from ptsharp.integrator import trace_compacted_static

            plain_chunk = self._chunk_fn
            raygen_j = jax.jit(raygen, static_argnames=("rows", "spp"))
            film_j = jax.jit(film_accumulate, static_argnames=("rows", "spp"))

            def compacted_chunk(scene, camera, key, row0, rows, spp,
                                weight_rows):
                r = rows * cfg.width * spp
                if not compaction_schedule(icfg, r):
                    return plain_chunk(scene, camera, key, row0, rows, spp,
                                       weight_rows)
                org, dirn, kt, sidx2, ju, jv, inv = raygen_j(
                    scene, camera, key, row0, rows, spp
                )
                n_strat = max(1, int(np.sqrt(spp))) if cfg.stratified else 1
                result = trace_compacted_static(scene, icfg, org, dirn, kt,
                                                sidx2, n_strat)
                return film_j(result, ju, jv, rows, spp, weight_rows, inv)

            self._chunk_fn = compacted_chunk

    def _render_pass(self, film: Film, key, spp: int, weight=None) -> Film:
        """One spp-sample pass over the whole image, chunked by rows.
        weight: optional (spp, H, W) mask."""
        if self._chunk_fn is None:
            self._build_chunk_fn()
        cfg = self.config
        rows_per = self._rows_per_chunk(spp)
        n_chunks = -(-cfg.height // rows_per)
        keys = jax.random.split(key, n_chunks)
        ray_counts = []
        for ci in range(n_chunks):
            row0 = ci * rows_per
            rows = min(rows_per, cfg.height - row0)
            wr = None if weight is None else weight[:, row0 : row0 + rows]
            chunk, rays = self._chunk_fn(
                self.scene, self.camera, keys[ci], row0, rows, spp, wr
            )
            film = _merge_rows(film, row0, chunk)
            ray_counts.append(rays)
        # single host sync per pass (per-chunk blocking would serialize the
        # device pipeline behind dispatch latency)
        self.rays_traced += int(sum(int(r) for r in ray_counts))
        return film

    # -- public API --------------------------------------------------------

    def render(self, film: Film | None = None, key=None) -> Film:
        """One full progressive pass: spp samples/pixel, then adaptive and
        firefly refinement (the RenderParallel pipeline, Renderer.cs:199-472)."""
        cfg = self.config
        if film is None:
            film = Film.zeros(cfg.height, cfg.width)
        if key is None:
            key = jax.random.PRNGKey(0)
        k1, k2, k3 = jax.random.split(key, 3)
        film = self._render_pass(film, k1, cfg.spp)

        if cfg.adaptive_samples > 0:
            # per-pixel extra-sample budget from luminance stddev
            # (Renderer.cs:340-416)
            stddev = colorlib.luminance(film.stddev())
            frac = jnp.clip(stddev / cfg.adaptive_threshold, 0.0, 1.0)
            extra = cfg.adaptive_samples * frac**cfg.adaptive_exponent
            s = cfg.adaptive_samples
            lane = jnp.arange(s, dtype=jnp.float32)[:, None, None]
            weight = (lane < extra[None]).astype(jnp.float32)
            film = self._render_pass(film, k2, s, weight)

        if cfg.firefly_samples > 0:
            # resample pixels whose stddev exceeds the threshold
            # (Renderer.cs:418-468)
            stddev = colorlib.luminance(film.stddev())
            mask = (stddev > cfg.firefly_threshold).astype(jnp.float32)
            weight = jnp.broadcast_to(
                mask[None], (cfg.firefly_samples,) + mask.shape
            )
            film = self._render_pass(film, k3, cfg.firefly_samples, weight)

        return film

    def iterative_render(
        self,
        iterations: int,
        key=None,
        path_template: str | None = None,
        film: Film | None = None,
        denoise: bool = False,
        verbose: bool = False,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
        viewer=None,
    ) -> Film:
        """Progressive refinement loop (IterativeRender, Renderer.cs:702-765):
        the film accumulates across iterations; each iteration optionally
        writes `path_template % iteration` as PNG. With checkpoint_path the
        film/key/iteration state persists every `checkpoint_every`
        iterations and resumes automatically if the file exists."""
        if key is None:
            key = jax.random.PRNGKey(0)
        cfg = self.config
        start_it = 0
        if checkpoint_path:
            import os

            from ptsharp.checkpoint import load_checkpoint

            if os.path.exists(checkpoint_path):
                film, start_it, key = load_checkpoint(checkpoint_path)
                if verbose:
                    print(f"resumed from {checkpoint_path} @ iter {start_it}")
        if film is None:
            film = Film.zeros(cfg.height, cfg.width)
        for it in range(start_it, iterations):
            t0 = time.time()
            film = self.render(film, jax.random.fold_in(key, it))
            if verbose:
                jax.block_until_ready(film.mean)
                dt = time.time() - t0
                print(
                    f"[{it + 1}/{iterations}] {cfg.width}x{cfg.height} "
                    f"spp+={cfg.spp} rays={self.rays_traced} {dt:.2f}s"
                )
            if path_template:
                save_png(film.color_srgb(), path_template % (it + 1)
                         if "%" in path_template else path_template)
            if checkpoint_path and checkpoint_every and (it + 1) % checkpoint_every == 0:
                from ptsharp.checkpoint import save_checkpoint

                save_checkpoint(checkpoint_path, film, it + 1, key)
            if viewer is not None:
                # live preview (the Program.Bitmap analogue)
                viewer.update(film.color_srgb())
        if denoise:
            from ptsharp.denoise import denoise_film

            img = denoise_film(film)
            if path_template:
                base = path_template % iterations if "%" in path_template else path_template
                save_png(colorlib.to_srgb(img), base.replace(".png", "_denoised.png"))
        return film


@functools.partial(jax.jit, donate_argnums=(0,))
def _merge_rows(film: Film, row0, chunk: Film) -> Film:
    """Welford-merge a row-chunk film into the full film at row offset.

    Jitted with the film DONATED: one fused dispatch with in-place
    buffers, where an eager version dispatched 10+ separate ops per chunk
    and copied every full-film buffer at each update-slice."""
    h = chunk.mean.shape[0]
    cur = Film(
        mean=jax.lax.dynamic_slice_in_dim(film.mean, row0, h, 0),
        m2=jax.lax.dynamic_slice_in_dim(film.m2, row0, h, 0),
        n=jax.lax.dynamic_slice_in_dim(film.n, row0, h, 0),
        albedo=jax.lax.dynamic_slice_in_dim(film.albedo, row0, h, 0),
        normal=jax.lax.dynamic_slice_in_dim(film.normal, row0, h, 0),
    )
    merged = cur.merge(chunk)
    return Film(
        mean=jax.lax.dynamic_update_slice_in_dim(film.mean, merged.mean, row0, 0),
        m2=jax.lax.dynamic_update_slice_in_dim(film.m2, merged.m2, row0, 0),
        n=jax.lax.dynamic_update_slice_in_dim(film.n, merged.n, row0, 0),
        albedo=jax.lax.dynamic_update_slice_in_dim(film.albedo, merged.albedo, row0, 0),
        normal=jax.lax.dynamic_update_slice_in_dim(film.normal, merged.normal, row0, 0),
    )
