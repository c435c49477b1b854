"""Test config: force an 8-device virtual CPU platform before JAX initialises.

Mirrors the reference's "Gloo on one host" trick for cluster-free distributed testing
(SURVEY.md §4): all sharding/collective tests run on a virtual CPU mesh.

Tests that need the GPU take the ``gpu`` fixture and carry the ``gpu`` marker;
they skip here. On the card: ``DGLL_TEST_GPU=1 python -m pytest tests -m gpu``.
"""
import os

import pytest

if os.environ.get("DGLL_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("DGLL_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: multi-process / long-running tests")
    config.addinivalue_line("markers", "gpu: needs a GPU; skips on a CPU host")


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default backend is {dev.platform}")
    return dev
