"""Tests that need a GPU: they skip without one (the `gpu` fixture) and run
on a GPU host through `python chip_smoke.py`."""
import numpy as np
import pytest
import scipy.sparse as sp

import ipx_tpu.testgen as tg
from ipx_tpu import LpSolver, Parameters


def _solve(data, **params):
    p = Parameters()
    p.display = 0
    for k, v in params.items():
        setattr(p, k, v)
    s = LpSolver(p)
    tg.load_into_solver(data, s)
    return s, s.solve()


@pytest.mark.chip
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_chip_spmv_matches_scipy(gpu, dt):
    """f32 products must not drop to TF32: 1e-5 relative, as on the CPU."""
    import jax
    import jax.numpy as jnp
    from ipx_tpu.ops.spmv import NormalMatrixDevice
    data = tg.transportation(2000, 3000, 4e-3, seed=1)
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]),
                      shape=(data["num_constr"], data["num_var"]))
    m, n = A.shape
    rng = np.random.default_rng(0)
    W = 10.0 ** rng.uniform(-3, 3, size=(n + m, 8))
    V = rng.standard_normal((m, 8))
    ref = A @ (W[:n] * (A.T @ V)) + W[n:] * V
    absA = abs(A)
    scale = absA @ (W[:n] * (absA.T @ np.abs(V))) + W[n:] * np.abs(V)
    nmd = NormalMatrixDevice(A, dtype=dt)
    out = jax.jit(nmd.apply_batched)(jnp.asarray(W, dt), jnp.asarray(V, dt))
    assert out.devices() == {gpu}
    err = np.max(np.abs(np.asarray(out, dtype=np.float64) - ref) / scale)
    assert err <= (1e-12 if dt == np.float64 else 1e-5), err


@pytest.mark.chip
def test_chip_gpu_solve_matches_host(gpu):
    data = tg.transportation(300, 450, 0.02, seed=3)
    host, st_host = _solve(data, device="cpu")
    dev, st_dev = _solve(data, device="gpu")
    assert st_host == st_dev == 1000
    assert dev.model._device_cr2.applies > 0
    assert dev.get_info().pobjval == pytest.approx(
        host.get_info().pobjval, rel=1e-8)


@pytest.mark.chip
def test_chip_auto_runs_phase1_on_gpu(gpu):
    from ipx_tpu.ops.device_cr import DeviceNormalCR
    data = tg.transportation(2000, 3000, 4e-3, seed=2)
    assert len(data["Ax"]) >= DeviceNormalCR.MIN_NNZ_AUTO
    s, st = _solve(data, device="auto")
    assert st == 1000
    assert hasattr(s.model, "_normal_device32")          # phase 1 on GPU
    assert getattr(s.model, "_device_cr2", None) is None  # phase 2 on host


@pytest.mark.chip
def test_chip_fleet_picks_f32(gpu):
    from ipx_tpu.parallel.batch import BatchedLp, BatchedPhase1Solver
    A = sp.random(30, 40, density=0.3, format="csc",
                  random_state=np.random.RandomState(0))
    lp = BatchedLp(A=A, b=np.ones((2, 30)), c=np.ones((2, 70)),
                   lb=np.zeros(70), ub=np.full(70, np.inf))
    assert BatchedPhase1Solver(lp).cr_dtype == "f32"
