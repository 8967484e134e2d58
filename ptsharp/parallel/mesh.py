"""Device mesh construction for pod-scale rendering.

The reference's parallelism is a shared-memory work-stealing tile scheduler
(WorkStealingScheduler.cs); the replacement here is *static tile ownership*
over a `jax.sharding.Mesh`: image rows shard over the "dp" axis, samples
per pixel over the "sp" axis, the scene (BVH + SoA tables + materials)
replicates, and film/gradient reductions are collectives (psum). The
cards of one host are joined all to all, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(dp: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh over the available devices. Defaults: all
    devices on the dp (image-tile) axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} devices"
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def single_device_mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
