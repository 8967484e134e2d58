"""Traversal A/B on the GPU: the per-lane Pallas kernel
(`intersector="pallas"`, pallas/traverse_gpu.py) against the XLA wide walk
(`intersector="wide"`, one lockstep loop over the whole wavefront).

Cells, per scene (bunny: 81,920 triangles; dragon_hd: 1,310,720):
  ch    closest-hit on 1M Morton-ordered 1080p primaries (bench.run_closest_hit)
  full  full trace with NEE over 256k compacted wavefronts (bench.run_scene)

Before timing, the kernel is checked against the XLA walk on the same 1M
rays: t within 1e-4 relative, and the same triangle on >= 99.9% of lanes
(FMA contraction on the GPU can flip ties on shared edges).

Each variant runs twice, in the order A B B A, so a drift of the card
over the call shows. Rows go to stdout and are appended to --out.
Run: python scripts/traversal_ab.py [--scenes bunny,dragon_hd] [--cells ch,full]
         [--out traversal_ab.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from ptsharp import platform  # noqa: E402

VARIANTS = ["pallas", "wide"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="bunny,dragon_hd")
    ap.add_argument("--cells", default="ch,full")
    ap.add_argument("--out", default="traversal_ab.jsonl")
    args = ap.parse_args()
    platform.require_gpu()
    platform.enable_compile_cache()
    device = platform.device_summary()
    print(json.dumps({"device": device}), flush=True)
    out = open(args.out, "a")

    def emit(row):
        row["device"] = device
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    for name in args.scenes.split(","):
        t0 = time.time()
        built = bench.build(name)
        from ptsharp.accel import bvh as bvh_mod
        emit({"scene": name, "build_s": time.time() - t0,
              "builder": bvh_mod.last_builder,
              "builds": dict(bvh_mod.build_counts)})
        emit({"scene": name, "parity": bench.traversal_parity(built)})
        for cell in args.cells.split(","):
            for inter in VARIANTS + VARIANTS[::-1]:
                scene = replace(built[0], intersector=inter)
                b = (scene,) + built[1:]
                t0 = time.time()
                try:
                    if cell == "ch":
                        v = bench.run_closest_hit(name, built=b)
                    else:
                        mc = 4 if name == "bunny" else 2
                        v = bench.run_scene(name, shift=18,
                                            max_measured_chunks=mc,
                                            split_raygen=True,
                                            compacted=True, built=b)
                    emit({"scene": name, "cell": cell, "variant": inter,
                          "mrays_s": v, "wall_s": time.time() - t0})
                except Exception as e:  # noqa: BLE001 — recorded per variant
                    emit({"scene": name, "cell": cell, "variant": inter,
                          "error": f"{type(e).__name__}: {str(e)[:400]}"})
    out.close()


if __name__ == "__main__":
    main()
