"""Platform helpers: which device runs, and where compiled programs are kept.

- `force_cpu()` pins JAX to the host CPU (tests, golden references). It sets
  both `JAX_PLATFORMS` and the `jax_platforms` config, before any backend is
  initialized.
- `device_summary()` names the device a measurement ran on, with the card's
  name and power limit as `nvidia-smi` reports them.
- `require_gpu()` is called by every measurement path: a number taken on the
  CPU must never be reported as a GPU number.
- `enable_compile_cache()` points JAX's persistent compilation cache at one
  fixed directory.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def force_cpu(virtual_devices: int = 0) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if virtual_devices and "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={virtual_devices}"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def enable_compile_cache() -> str:
    """Use `$JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it
    itself, so nothing else is set); otherwise `<repo>/.jax_cache`. The
    path is part of the cache key, so it must not move between runs.
    Returns the directory in use."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W"; None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else None


def device_summary() -> dict:
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "name_power_limit": gpu_name_and_power_limit(),
    }


def require_gpu() -> None:
    """Raise unless JAX's default device is a GPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"this measurement needs a GPU; JAX found {platform!r}")
