"""Test harness config: CPU with 8 virtual devices, unless asked for a GPU.

Multi-chip sharding tests run on a virtual CPU mesh (the capability the
reference lacks — it can only exercise multi-GPU on real hardware,
SURVEY.md §4). The backend is retargeted through jax.config before any op
runs, in case jax was imported before this file.

Tests marked ``gpu`` need a CUDA device: they take the ``gpu_device``
fixture, which skips them on the CPU. Run them on a card with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`` (the host CPU is
the reference); any JAX_PLATFORMS other than ``cpu`` turns the CPU forcing
below off.
"""

import os

import pytest

FORCE_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"

if FORCE_CPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if FORCE_CPU:
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped on the CPU"
    )


def pytest_sessionstart(session):
    if not FORCE_CPU:
        return
    devs = jax.devices()
    assert devs[0].platform == "cpu", f"tests must run on CPU, got {devs}"
    assert len(devs) == 8, f"expected 8 virtual CPU devices, got {len(devs)}"


@pytest.fixture
def gpu_device():
    """The first CUDA device, or a skip when the run has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA device; this run has {dev.platform}")
    return dev
