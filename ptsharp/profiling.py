"""Profiling & observability.

The reference's only instrumentation is Stopwatch wall-clock prints and an
atomic ray counter nobody reads (SURVEY.md §5). Here:
  * `trace_to(dir)` wraps a block in a jax.profiler trace (view in
    TensorBoard / xprof) — kernel-level timing on the device,
  * `RenderStats` aggregates rays/s and pass timings from the renderer's
    on-device counters,
  * `print_device_memory()` dumps live buffer usage per device.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@contextlib.contextmanager
def trace_to(log_dir: str):
    with jax.profiler.trace(log_dir):
        yield


@dataclass
class RenderStats:
    rays: int = 0
    seconds: float = 0.0
    passes: int = 0
    history: list = field(default_factory=list)

    @contextlib.contextmanager
    def timed_pass(self):
        t0 = time.time()
        yield
        dt = time.time() - t0
        self.seconds += dt
        self.passes += 1
        self.history.append(dt)

    def add_rays(self, n: int):
        self.rays += int(n)

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    def summary(self) -> str:
        return (
            f"{self.rays:,} rays in {self.seconds:.2f}s over {self.passes} "
            f"passes = {self.mrays_per_sec:.1f} Mrays/s"
        )


def print_device_memory() -> None:
    for d in jax.devices():
        try:
            stats = d.memory_stats()
            used = stats.get("bytes_in_use", 0) / 2**20
            limit = stats.get("bytes_limit", 0) / 2**20
            print(f"{d}: {used:.1f} MiB / {limit:.1f} MiB")
        except Exception:
            print(f"{d}: memory stats unavailable")
