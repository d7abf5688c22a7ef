"""Test configuration.

Tests run on a virtual 8-device CPU mesh with x64 enabled so that
(a) multi-device sharding logic is exercised without accelerator hardware
and (b) host-factorization math runs at the reference's float64 accuracy
(reference is f64 end-to-end via BF_DOUBLE, meson.build:25).

Tests marked `gpu` need an NVIDIA GPU: they take the `gpu` fixture, which
skips them anywhere else. `chip_smoke.py` runs them on the card with
BUTTERFLY_TEST_PLATFORM set to the empty string, which leaves the backend
to JAX instead of forcing the CPU.
"""

import os

# XLA_FLAGS must be set before the backend initializes.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

_platform = os.environ.get("BUTTERFLY_TEST_PLATFORM", "cpu")
if _platform:
    jax.config.update("jax_platforms", _platform)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first device, when it is an NVIDIA GPU; skips otherwise. Decided
    here, at run time, never while test modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (backend is {dev.platform})")
    return dev
