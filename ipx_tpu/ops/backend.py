"""The JAX runtime that every device path shares.

- get_jax(): the lazy JAX import, with x64 on and the persistent compile
  cache set up.
- accelerator(): the device that jitted programs run on. Placement comes
  from JAX_PLATFORMS and nothing else: programs run on jax.devices()[0].
- require_accelerator(): the platform check behind Parameters.device="gpu".

No device path falls back to the host: a requested device path that cannot
build or run raises DeviceError.
"""
from __future__ import annotations

import contextlib
import os
from typing import Mapping, Optional

# Platforms the device paths run on. The tests add "cpu" through a fixture
# so that the same jitted programs run on the CPU backend.
ACCELERATOR_PLATFORMS = ("gpu",)

# The in-checkout compile cache (listed in .gitignore).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


class DeviceError(RuntimeError):
    """A device path was requested but cannot build or run."""


@contextlib.contextmanager
def device_path(what: str):
    """Re-raises any failure inside the block as DeviceError naming `what`,
    which LpSolver.solve raises instead of returning a solver status."""
    try:
        yield
    except DeviceError:
        raise
    except Exception as e:
        raise DeviceError(f"{what} failed: {e}") from e


def compile_cache_dir(platform: str,
                      environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """Where compiled programs are kept. JAX_COMPILATION_CACHE_DIR wins when
    set (JAX reads it itself). Otherwise the fixed in-checkout directory,
    but only for GPU programs: XLA:CPU entries are compiled for the host
    CPU and can die with SIGILL when a checkout is copied to another
    machine. None means no persistent cache."""
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return CACHE_DIR if platform == "gpu" else None


_jax = None


def get_jax():
    """Imports JAX once, with x64 enabled and the compile cache set."""
    global _jax
    if _jax is None:
        import jax
        jax.config.update("jax_enable_x64", True)
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            cache = compile_cache_dir(jax.default_backend())
            if cache is not None:
                os.makedirs(cache, exist_ok=True)
                jax.config.update("jax_compilation_cache_dir", cache)
        _jax = jax
    return _jax


def accelerator():
    """The device that jitted programs run on."""
    return get_jax().devices()[0]


def require_accelerator():
    """Returns accelerator(), or raises DeviceError when it is not a GPU."""
    dev = accelerator()
    if dev.platform not in ACCELERATOR_PLATFORMS:
        raise DeviceError(
            f'device="gpu" needs a GPU, but JAX runs on {dev.platform!r} '
            f"({dev.device_kind}); check JAX_PLATFORMS and the CUDA "
            f'plugin, or use device="cpu"')
    return dev
