"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64.

Multi-device sharding is validated on host-platform virtual devices
(``xla_force_host_platform_device_count=8``); the GPU path is exercised
by ``chip_smoke.py`` and by the tests marked ``gpu``, which skip here.
"""

import os

# Must be set before jax is imported anywhere.  CPU unless the caller
# names a platform (`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`
# runs the card's tests on the card).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from go_audio_resampler_tpu.utils import compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: XLA:CPU compiles of the conv/gather programs
# take seconds each; cache them across pytest runs.
compile_cache.enable(min_compile_time_secs=0.3)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided per test, never
    at import, so every xdist worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run on the card with "
                    "`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`")
    return jax.devices()[0]
