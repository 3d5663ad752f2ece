"""Device choice by platform, with no fallback that hides a missing GPU;
the compile cache location; the native build key."""
import pytest

from ipx_tpu import DeviceError, LpSolver, Parameters
from ipx_tpu.native import build
from ipx_tpu.ops import backend

from lp_fixtures import random_lp


def _solver(device, shards=0):
    a = random_lp(20, 30, density=0.2, seed=1)
    p = Parameters()
    p.display = 0
    p.device = device
    p.shards = shards
    s = LpSolver(p)
    assert s.load_model(a["num_var"], a["obj"], a["lb"], a["ub"],
                        a["num_constr"], a["Ap"], a["Ai"], a["Ax"],
                        a["rhs"], a["constr_type"]) == 0
    return s


def test_gpu_device_without_gpu_raises():
    with pytest.raises(DeviceError, match="needs a GPU"):
        _solver("gpu").solve()


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="auto, cpu or gpu"):
        _solver("tpu").solve()


def test_auto_keeps_host_without_gpu():
    """Auto mode takes the device path only on a GPU; on the CPU backend
    it solves on the host."""
    s = _solver("auto")
    assert s.solve() == 1000
    assert not hasattr(s.model, "_normal_device32")


def test_auto_rule_by_size_and_platform(monkeypatch):
    """Auto mode takes the phase-1 device path for models with at least
    MIN_NNZ_AUTO nonzeros, and only on an accelerator platform."""
    import types
    import scipy.sparse as sp
    from ipx_tpu.ops.device_cr import DeviceNormalCR
    small = types.SimpleNamespace(A=sp.random(40, 60, density=0.1))
    large = types.SimpleNamespace(A=sp.random(400, 600, density=0.1))
    assert large.A.nnz >= DeviceNormalCR.MIN_NNZ_AUTO > small.A.nnz
    assert not DeviceNormalCR.worthwhile(large)         # CPU backend
    monkeypatch.setattr(backend, "ACCELERATOR_PLATFORMS", ("gpu", "cpu"))
    assert DeviceNormalCR.worthwhile(large)
    assert not DeviceNormalCR.worthwhile(small)


def test_shards_beyond_devices_raise():
    import jax
    from ipx_tpu.parallel.sharding import make_row_mesh
    n = len(jax.devices())
    assert make_row_mesh(n).devices.size == n
    with pytest.raises(DeviceError, match=f"shards={n + 1} needs"):
        make_row_mesh(n + 1)


def test_shards_beyond_devices_raise_from_solve():
    import jax
    with pytest.raises(DeviceError, match="needs"):
        _solver("auto", shards=len(jax.devices()) + 1).solve()


@pytest.mark.parametrize("platform,environ,expected", [
    ("gpu", {}, backend.CACHE_DIR),
    ("cpu", {}, None),
    ("gpu", {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "/elsewhere"),
    ("cpu", {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "/elsewhere"),
])
def test_compile_cache_dir(platform, environ, expected):
    assert backend.compile_cache_dir(platform, environ) == expected


def test_compile_cache_dir_is_in_checkout_and_ignored():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(backend.CACHE_DIR) == root
    with open(os.path.join(root, ".gitignore")) as f:
        assert os.path.basename(backend.CACHE_DIR) + "/" in f.read().split()


def test_native_build_key_changes_with_source_flags_and_cpu():
    key = build.build_key(b"int f();", build.FLAGS, "cpu-a")
    assert key == build.build_key(b"int f();", build.FLAGS, "cpu-a")
    assert key != build.build_key(b"int g();", build.FLAGS, "cpu-a")
    assert key != build.build_key(b"int f();", build.FLAGS + ("-g",),
                                  "cpu-a")
    assert key != build.build_key(b"int f();", build.FLAGS, "cpu-b")


def test_native_library_is_keyed_by_this_source():
    import os
    path = build.build()
    assert path == build.library_path()
    assert os.path.dirname(os.path.dirname(path)) == build.BUILD_DIR
    with open(build.SRC, "rb") as f:
        key = build.build_key(f.read(), build.FLAGS, build.cpu_identity())
    assert os.path.basename(os.path.dirname(path)) == key


def test_device_path_failure_raises(cpu_as_gpu, monkeypatch):
    """A device path that fails to build raises DeviceError from solve()
    instead of continuing on the host."""
    from ipx_tpu.ops import device_cr

    def broken(*a, **k):
        raise RuntimeError("no program")
    monkeypatch.setattr(device_cr.MixedPrecisionDeviceCR, "__init__", broken)
    with pytest.raises(DeviceError, match="device phase-1 CR setup failed"):
        _solver("gpu").solve()
