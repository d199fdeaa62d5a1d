"""Test harness configuration.

Runs the suite on a virtual 8-device CPU mesh with float64 enabled so the
sharded code paths execute without a GPU and numerical oracles hold at
reference (double) precision.  Must set env before jax import.

Tests marked `gpu` take the `gpu` fixture and skip without a card; on a
GPU machine run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

# the CPU backend unless the caller names platforms (the gpu-marked tests)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "true")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX has {dev.platform}")
    return dev
