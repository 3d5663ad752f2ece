"""Device CR path: equality with the host CR path on the same LP."""
import numpy as np
import pytest

from ipx_tpu import LpSolver, Parameters
from ipx_tpu.ops.device_cr import DeviceNormalCR

from lp_fixtures import random_lp


def _solve(device, a):
    p = Parameters()
    p.display = 0
    p.device = device
    s = LpSolver(p)
    assert s.load_model(a["num_var"], a["obj"], a["lb"], a["ub"],
                        a["num_constr"], a["Ap"], a["Ai"], a["Ax"],
                        a["rhs"], a["constr_type"]) == 0
    s.solve()
    return s.get_info()


def test_device_cr_matches_host(cpu_as_gpu):
    a = random_lp(60, 80, density=0.2, seed=3)
    # force the device path regardless of size by setting device="gpu"
    # (runs on the CPU backend through the cpu_as_gpu fixture)
    info_host = _solve("cpu", a)
    info_dev = _solve("gpu", a)
    assert info_dev.status == info_host.status
    assert info_dev.objval == pytest.approx(info_host.objval, rel=1e-8)
    assert info_dev.primal_infeas <= 1e-7
    assert info_dev.dual_infeas <= 1e-7


def test_device_cr_direct():
    """Direct comparison: device CR solves the normal equations."""
    import scipy.sparse as sp
    from ipx_tpu.model import Model
    from ipx_tpu.user_model import UserModel
    from ipx_tpu.presolve import Presolver
    from ipx_tpu.control import Control

    a = random_lp(50, 70, density=0.2, seed=5)
    um = UserModel()
    assert um.load(a["num_constr"], a["num_var"], a["Ap"], a["Ai"], a["Ax"],
                   a["rhs"], a["constr_type"], a["obj"], a["lb"],
                   a["ub"]) == 0
    md = Model()
    pre = Presolver(um, md)
    ctrl = Control()
    ctrl.parameters.display = 0
    pre.presolve_model(ctrl)

    m, n = md.num_rows, md.num_cols
    rng = np.random.default_rng(0)
    W = rng.uniform(0.5, 2.0, size=n + m)
    from ipx_tpu.sparse import normal_diag
    diag = normal_diag(md.A, W)
    resscale = 1.0 / np.sqrt(W[n:])
    rhs = rng.standard_normal(m)

    dcr = DeviceNormalCR(md, W, diag, resscale)
    y, iters, err, _, _ = dcr.solve(rhs, 1e-10, -1)
    assert err == 0
    # residual of the normal equations
    res = rhs - (md.A @ (W[:n] * (y @ md.A_csr)) + W[n:] * y)
    assert np.max(np.abs(resscale * res)) <= 1e-9
    assert iters > 0


def test_mixed_precision_cr_reaches_f64_tolerance():
    """The f32-inner/f64-refinement solver must reach tolerances far below
    what a single f32 solve can resolve (defect correction)."""
    from ipx_tpu.model import Model
    from ipx_tpu.user_model import UserModel
    from ipx_tpu.presolve import Presolver
    from ipx_tpu.control import Control
    from ipx_tpu.ops.device_cr import MixedPrecisionDeviceCR
    from ipx_tpu.sparse import normal_diag

    a = random_lp(50, 70, density=0.2, seed=5)
    um = UserModel()
    assert um.load(a["num_constr"], a["num_var"], a["Ap"], a["Ai"], a["Ax"],
                   a["rhs"], a["constr_type"], a["obj"], a["lb"],
                   a["ub"]) == 0
    md = Model()
    ctrl = Control()
    ctrl.parameters.display = 0
    Presolver(um, md).presolve_model(ctrl)

    m, n = md.num_rows, md.num_cols
    rng = np.random.default_rng(0)
    W = rng.uniform(0.5, 2.0, size=n + m)
    diag = normal_diag(md.A, W)
    resscale = 1.0 / np.sqrt(W[n:])
    rhs = rng.standard_normal(m)

    mcr = MixedPrecisionDeviceCR(md, W, diag, resscale)
    y, iters, err, _, _ = mcr.solve(rhs, 1e-11, -1)
    assert err == 0
    res = rhs - (md.A @ (W[:n] * (y @ md.A_csr)) + W[n:] * y)
    assert np.max(np.abs(resscale * res)) <= 1e-11
    assert iters > 0


def test_mixed_precision_cr_in_full_solve(cpu_as_gpu):
    """device='gpu' (CPU backend through cpu_as_gpu) routes phase 1 through
    the mixed-precision solver and still reaches the default tolerances."""
    a = random_lp(80, 120, density=0.15, seed=9)
    info_host = _solve("cpu", a)
    info_dev = _solve("gpu", a)
    assert info_dev.status == info_host.status
    assert info_dev.objval == pytest.approx(info_host.objval, rel=1e-8)


def test_mixed_precision_host_cr_f64_finish_on_hard_system():
    """On an ill-conditioned normal matrix the f32 passes stall; the mixed
    host CR must hand off to the f64 core and still meet the tolerance."""
    import ctypes as ct
    from ipx_tpu.model import Model
    from ipx_tpu.user_model import UserModel
    from ipx_tpu.presolve import Presolver
    from ipx_tpu.control import Control
    from ipx_tpu.kkt.diag import KKTSolverDiag
    from ipx_tpu.info import Info

    a = random_lp(60, 90, density=0.2, seed=2)
    um = UserModel()
    assert um.load(a["num_constr"], a["num_var"], a["Ap"], a["Ai"], a["Ax"],
                   a["rhs"], a["constr_type"], a["obj"], a["lb"],
                   a["ub"]) == 0
    md = Model()
    ctrl = Control()
    ctrl.parameters.display = 0
    ctrl.parameters.device = "cpu"
    Presolver(um, md).presolve_model(ctrl)
    m, n = md.num_rows, md.num_cols

    kkt = KKTSolverDiag(ctrl, md)

    class FakeIterate:
        pass

    # weight spread well beyond f32 resolution (condition ~1e7), so the f32
    # passes must hand off to the f64 finish to reach the 1e-11 tolerance
    rng = np.random.default_rng(0)
    it = FakeIterate()
    it.barrier_lb_mask = np.ones(n + m, dtype=bool)
    it.barrier_ub_mask = np.zeros(n + m, dtype=bool)
    it.zl = 10.0 ** rng.uniform(-3.5, 3.5, size=n + m)
    it.xl = np.ones(n + m)
    it.zu = np.ones(n + m)
    it.xu = np.ones(n + m)
    it.mu = lambda: 1e-8
    a_vec = rng.standard_normal(n + m)
    b_vec = rng.standard_normal(m)

    results = {}
    for prec in ("mixed", "f64"):
        ctrl.parameters.precision = prec
        kkt = KKTSolverDiag(ctrl, md)
        info = Info()
        kkt.factorize(it, info)
        assert info.errflag == 0
        kkt.maxiter = 50 * m
        x, y = kkt.solve(a_vec, b_vec, 1e-11, info)
        assert np.all(np.isfinite(x)) and np.all(np.isfinite(y))
        results[prec] = (info.errflag, x, y)
    # both precisions converge and meet the same residual contract: the
    # solution residual lives only in the slack rows, scaled by resscale
    for prec, (errflag, x, y) in results.items():
        assert errflag == 0, (prec, errflag)
        rb = b_vec - md.AI_mul(x)
        assert np.max(np.abs(kkt.resscale * rb)) <= 1e-10, prec
