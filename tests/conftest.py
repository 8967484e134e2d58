"""Test harness.

By default the suite runs on an 8-virtual-device CPU platform, so sharding
logic is exercised without accelerators (SURVEY.md §4 implication) and
compiles stay fast. Both the env var and `jax.config.update` are set, before
any backend is initialized.

Tests marked `gpu` compare compiled GPU kernels with their references. They
skip on the CPU; `python chip_smoke.py` runs them on the card, in its own
process, with PTSHARP_TEST_ON_GPU=1 (which leaves JAX on its default device).
"""

import os

import pytest

ON_GPU = os.environ.get("PTSHARP_TEST_ON_GPU") == "1"

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

from ptsharp import platform  # noqa: E402

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

# persistent compilation cache: shaves repeated-suite compile time
platform.enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """`gpu`-marked tests run only where the default device is a GPU. The
    check runs per test, never at import, so every xdist worker collects
    the same tests."""
    if request.node.get_closest_marker("gpu") and \
            jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: `python chip_smoke.py` runs it on the card")
