"""Test harness config: run on the host CPU with an 8-device virtual mesh.

Sharding tests emulate the mesh on CPU devices (SURVEY.md §4: the reference
likewise has no multi-node test rig). Pallas kernels run in interpret mode.
XLA_FLAGS must be set before the CPU backend initializes.

Tests that only a GPU can run carry the `gpu` marker and take the `gpu`
fixture, which skips them when JAX finds no GPU; `python chip_smoke.py`
covers the same ground on the card.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped where JAX finds none")


@pytest.fixture
def gpu():
    """Skip the test unless the default JAX backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (covered on the card by chip_smoke.py)")
