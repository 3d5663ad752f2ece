"""Device phase-2 CR (ops/device_cr2.py): the basis-preconditioned KKT
solves route through the device splitted-operator CR (NN' product jitted
on the jax backend; host-looped recurrences and B/B' solves, callback-free
per VERDICT r3 item 5) and reproduce the host path's results. device="gpu"
runs on the CPU backend through the cpu_as_gpu fixture."""
import numpy as np
import pytest

from ipx_tpu import LpSolver, Parameters
import ipx_tpu.testgen as tg


@pytest.mark.parametrize("family", ["transport", "grid"])
def test_device_phase2_matches_host(family, monkeypatch, cpu_as_gpu):
    from ipx_tpu.ops import device_cr2
    calls = []
    orig = device_cr2.DeviceSplittedCR.solve

    def counted(self, rhs, tol, maxiter, **kw):
        out = orig(self, rhs, tol, maxiter, **kw)
        calls.append(out[1])
        return out

    monkeypatch.setattr(device_cr2.DeviceSplittedCR, "solve", counted)
    data = (tg.transportation(120, 180, 0.05, seed=4) if family ==
            "transport" else tg.grid_flow(16, 16, seed=2))
    objs = {}
    for dev in ("cpu", "gpu"):
        p = Parameters()
        p.display = 0
        p.device = dev
        s = LpSolver(p)
        tg.load_into_solver(data, s)
        assert s.solve() == 1000, dev
        objs[dev] = s.get_info().pobjval
    assert objs["gpu"] == pytest.approx(objs["cpu"], rel=1e-7)
    # the device CR actually carried the phase-2 solves (no silent host
    # fallback) and iterated
    assert calls and sum(calls) > 0


def test_device_splitted_cr_operator_equivalence():
    """DeviceSplittedCR.solve solves C y = rhs for the same operator the
    host SplittedNormalMatrix applies."""
    from ipx_tpu.control import Control
    from ipx_tpu.ops.device_cr2 import DeviceSplittedCR

    data = tg.transportation(80, 120, 0.06, seed=9)
    p = Parameters()
    p.display = 0
    p.device = "cpu"
    p.stop_at_switch = 1          # stop right after the basis is built
    s = LpSolver(p)
    tg.load_into_solver(data, s)
    s.solve()
    basis = s.basis
    assert basis is not None
    md = basis.model
    iterate = s.iterate
    from ipx_tpu.kkt.splitted_normal import SplittedNormalMatrix
    sn = SplittedNormalMatrix(md)
    sn.prepare(basis, iterate.scaling_factors())

    dcr = DeviceSplittedCR(md)
    dcr.prepare(sn)
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal(md.num_rows)
    if sn.free_positions.size:
        rhs[sn.free_positions] = 0.0
    y, iters, err = dcr.solve(rhs, tol=1e-10, maxiter=5000)
    assert err == 0 and iters > 0
    # residual through the host operator
    Cy, _ = sn._apply(y, want_dot=False)
    assert np.max(np.abs(rhs - Cy)) <= 1e-8 * max(1.0, np.abs(rhs).max())
