"""Multi-host entry points.

The reference is single-process shared-memory (SURVEY.md §5: no distributed
backend; inter-thread queues only). The replacement is JAX's
multi-controller runtime: every host calls :func:`initialize` once, after
which `jax.devices()` spans every host's cards and the `shard_map`
renderers in `parallel.shard` scale across hosts unchanged — scene/BVH
arrays replicate per card, image rows and sample shards ride the (dp, sp)
mesh, film/grad reductions are psums that XLA hands to NCCL.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the multi-host runtime (jax.distributed.initialize).

    Nothing detects a GPU cluster by itself: pass coordinator_address
    ("host:port"), num_processes and process_id. Single-process runs may
    skip calling this entirely — every helper below works either way.
    """
    # NOTE: do NOT probe jax.process_count() here — it instantiates the
    # local backend (returning 1 when uninitialized), after which the real
    # jax.distributed.initialize raises, and a multi-host run would then
    # silently degrade to per-host single-process runs.
    if _is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as e:
        if num_processes in (None, 1) and coordinator_address is None:
            # single-process smoke path: no multi-host args were provided
            # and no coordinator is reachable — the local runtime works
            return
        raise e


def _is_initialized() -> bool:
    """True iff jax.distributed.initialize has already succeeded in this
    process (checked on the client handle, not via process_count, which
    spins up the local backend as a side effect)."""
    try:
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None
    except Exception:  # pragma: no cover - private-API drift fallback
        return False


def global_mesh(dp: int | None = None, sp: int = 1,
                devices=None) -> Mesh:
    """Build the (dp, sp) render mesh over all global devices (every host
    sees the same mesh; shard_map handles the cross-host addressing)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"dp*sp ({dp}*{sp}) != device count {n}"
    return Mesh(devices.reshape(dp, sp), ("dp", "sp"))


def process_summary() -> dict:
    """Host/pod topology snapshot (observability hook)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.devices()[0].platform,
    }
