"""Render every catalog scene to a PNG contact sheet directory — the
golden-scene acceptance pass mirroring the reference's Example.cs usage
(SURVEY.md §4). Run: python scripts/render_catalog.py [outdir] [scale]

Runs on CPU by default (fast compiles); set PTSHARP_CATALOG_GPU=1 to render
on the GPU instead.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if not os.environ.get("PTSHARP_CATALOG_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import time

import numpy as np

from ptsharp import examples
from ptsharp.film import save_png
from ptsharp.renderer import Renderer, RenderConfig


def main(outdir="catalog_out", scale=0.25):
    scale = float(scale)
    os.makedirs(outdir, exist_ok=True)
    failures = []
    for name in sorted(examples.CATALOG):
        t0 = time.time()
        try:
            scene, cam, rcfg, icfg = examples.build(name)
            w = max(32, int(rcfg.width * scale))
            h = max(24, int(rcfg.height * scale))
            # budget ~1M camera rays per scene so heavy meshes stay quick
            spp = max(1, min(rcfg.spp, 8, (1 << 20) // (w * h)))
            r = Renderer(scene, cam, RenderConfig(width=w, height=h, spp=spp),
                         icfg)
            film = r.render(key=jax.random.PRNGKey(0))
            img = np.asarray(film.color_srgb())
            assert np.isfinite(img).all(), "non-finite pixels"
            save_png(film.color_srgb(), os.path.join(outdir, f"{name}.png"))
            print(f"{name:16s} ok  {w}x{h}  mean={img.mean():.3f}  "
                  f"{time.time()-t0:6.1f}s", flush=True)
        except Exception as e:
            failures.append(name)
            print(f"{name:16s} FAIL {str(e)[:120]}", flush=True)
    if failures:
        print("FAILED:", failures)
        sys.exit(1)
    print(f"all {len(examples.CATALOG)} scenes rendered to {outdir}/")


if __name__ == "__main__":
    main(*(sys.argv[1:3] if len(sys.argv) > 1 else ()))
