"""Test configuration: x64 enabled, and 8 virtual CPU devices, so that with
JAX_PLATFORMS=cpu the device and sharding paths run without a GPU.

Tests that need a real GPU carry the `chip` marker (pytest.ini) and take
the `gpu` fixture, which skips them when JAX finds none. On a GPU host
they run with `python chip_smoke.py`, or with
`python -m pytest -m chip -p no:xdist tests/` (one process per card).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The GPU that jitted programs run on; skips the test without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture
def cpu_as_gpu(monkeypatch):
    """Lets the platform check accept the CPU backend, so device="gpu" runs
    the same jitted device programs on the CPU."""
    from ipx_tpu.ops import backend
    monkeypatch.setattr(backend, "ACCELERATOR_PLATFORMS", ("gpu", "cpu"))
