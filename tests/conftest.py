"""Test env: force CPU with 8 virtual devices so multi-device sharding tests
run without accelerators (SURVEY.md §4 'fake backend' analog).

`OCCUSEG_TEST_GPU=1` leaves the platform alone, for running the tests
marked `gpu` on a machine with a card:

    OCCUSEG_TEST_GPU=1 python -m pytest -m gpu tests/

Those tests decide inside a fixture whether there is a card and skip
without one.
"""

import os

if os.environ.get("OCCUSEG_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import jax  # noqa: E402
import pytest  # noqa: E402

from occuseg.utils.runtime import enable_compile_cache  # noqa: E402

if os.environ.get("OCCUSEG_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with OCCUSEG_TEST_GPU=1 on a "
                    "machine with a card)")
    return jax.devices()[0]
