"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: full solve wall-clock of a structured (transportation) LP through
the complete pipeline (presolve -> 2-phase IPM -> crossover), the scenario
the reference's own benchmarks measure (SURVEY.md §6).

vs_baseline compares against scipy's `linprog(method="highs-ipm")` on the
SAME instance — HiGHS embeds the reference IPX itself (compiled C++ with
HiGHS presolve + IPX IPM + crossover), so this is a direct wall-clock ratio
vs CPU IPX, the comparison BASELINE.md asks for. Values > 1 mean this
framework beats the C++ reference end-to-end.

Also reported in "extra": the HiGHS comparator times, the naive-python
speedup (native kernels disabled), KKT matvec throughput (the reference's
hot loop) for the host-native and device paths, and the batched phase-1
stage on the device. Device numbers are measured in this process and name
the device and the card's power limit; without a GPU the run fails.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def full_solve(m_sources=8000, m_sinks=12000, seed=1, density=0.001):
    from ipx_tpu import LpSolver, Parameters
    from ipx_tpu.testgen import transportation, load_into_solver
    data = transportation(m_sources, m_sinks, density, seed)
    p = Parameters()
    p.display = 0
    p.device = "cpu"
    s = LpSolver(p)
    load_into_solver(data, s)
    t0 = time.perf_counter()
    status = s.solve()
    dt = time.perf_counter() - t0
    info = s.get_info()
    return dt, data, (status, info.status_ipm, info.status_crossover,
                      info.iter, info.kktiter1 + info.kktiter2)


def highs_solve_time(data, method="highs-ipm"):
    """Wall clock of scipy linprog/HiGHS on the same instance. highs-ipm is
    HiGHS's embedded IPX (the reference, compiled C++), crossover on."""
    import scipy.sparse as sp
    from scipy.optimize import linprog
    m, n = data["num_constr"], data["num_var"]
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]), shape=(m, n))
    ct = np.array(list(data["constr_type"]))
    eq, lt, gt = ct == "=", ct == "<", ct == ">"
    A_ub_parts, b_ub_parts = [], []
    if lt.any():
        A_ub_parts.append(A[np.nonzero(lt)[0]])
        b_ub_parts.append(data["rhs"][lt])
    if gt.any():
        A_ub_parts.append(-A[np.nonzero(gt)[0]])
        b_ub_parts.append(-data["rhs"][gt])
    kw = dict(
        A_ub=sp.vstack(A_ub_parts) if A_ub_parts else None,
        b_ub=np.concatenate(b_ub_parts) if b_ub_parts else None,
        A_eq=A[np.nonzero(eq)[0]] if eq.any() else None,
        b_eq=data["rhs"][eq] if eq.any() else None,
        bounds=np.stack([data["lb"], data["ub"]], axis=1))
    t0 = time.perf_counter()
    res = linprog(data["obj"], method=method, **kw)
    dt = time.perf_counter() - t0
    return dt, int(res.status)


def host_matvec_rate(data, iters=40):
    import scipy.sparse as sp
    m, n = data["num_constr"], data["num_var"]
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]), shape=(m, n))
    A_csr = A.tocsr()
    rng = np.random.default_rng(1)
    W = rng.uniform(0.5, 2.0, size=n + m)
    v = rng.standard_normal(m)
    u = (v @ A_csr) * W[:n]
    out = A @ u + W[n:] * v
    t0 = time.perf_counter()
    for _ in range(iters):
        u = (v @ A_csr) * W[:n]
        out = A @ u + W[n:] * v
    return iters / (time.perf_counter() - t0)


def native_matvec_rate(data, iters=40):
    from ipx_tpu.model import Model
    from ipx_tpu.user_model import UserModel
    from ipx_tpu.presolve import Presolver
    from ipx_tpu.control import Control
    from ipx_tpu.kkt.normal_matrix import NormalMatrix
    um = UserModel()
    um.load(data["num_constr"], data["num_var"], data["Ap"], data["Ai"],
            data["Ax"], data["rhs"], data["constr_type"], data["obj"],
            data["lb"], data["ub"])
    md = Model()
    ctrl = Control()
    ctrl.parameters.display = 0
    ctrl.parameters.scale = 0
    Presolver(um, md).presolve_model(ctrl)
    rng = np.random.default_rng(1)
    W = rng.uniform(0.5, 2.0, size=md.num_var_all)
    nm = NormalMatrix(md)
    nm.prepare(W)
    v = rng.standard_normal(md.num_rows)
    nm.apply(v)
    t0 = time.perf_counter()
    for _ in range(iters):
        nm.apply(v)
    return iters / (time.perf_counter() - t0)


def card() -> str:
    """Name and power limit of the card (nvidia-smi, a child process that
    does not import JAX)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def device_matvec_rates(jax, src, snk, seed):
    """Looped normal-matrix applies on the device: single-vector rates in
    f64 and f32, and the per-vector-equivalent rate of the batched B=256
    f32 apply (the scenario fleet's hot operation)."""
    import scipy.sparse as sp
    from ipx_tpu.ops.spmv import NormalMatrixDevice
    from ipx_tpu.testgen import transportation
    jnp = jax.numpy
    data = transportation(src, snk, 0.001, seed)
    m, n = data["num_constr"], data["num_var"]
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]), shape=(m, n))
    rng = np.random.default_rng(1)
    out = {}
    for name, dt, B, K in (("f64", np.float64, 1, 200),
                           ("f32", np.float32, 1, 200),
                           ("f32_batched256", np.float32, 256, 50)):
        nmd = NormalMatrixDevice(A, dtype=dt)
        shape = (m,) if B == 1 else (m, B)
        W = jnp.asarray(rng.uniform(0.5, 2.0, size=(n + m,) + shape[1:]), dt)
        V = jnp.asarray(rng.standard_normal(shape), dt)

        def looped(W, V):
            def body(i, U):
                U = nmd.apply_batched(W, U)
                return U / jnp.max(jnp.abs(U))
            return jax.lax.fori_loop(0, K, body, V)
        fn = jax.jit(looped)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(W, V))
        out[name + "_compile_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            o = fn(W, V)
        jax.block_until_ready(o)
        out[name + "_rate"] = 3 * K * B / (time.perf_counter() - t0)
    return out


def batched_stage_metrics(src=8000, snk=12000, B=256):
    """Batched phase-1 stage on the device (m=20k, B=256, handoff rule):
    wall after a compile warm-up, steps and CR trips."""
    from ipx_tpu.parallel.batch import BatchedPhase1Solver, \
        BatchedScenarioSolver
    from ipx_tpu.testgen import transportation
    data = transportation(src, snk, 0.001, 1)
    m = data["num_constr"]
    rng = np.random.default_rng(0)
    fac = np.empty((B, m))
    fac[:, :src] = rng.uniform(1.0, 1.1, size=(B, src))
    fac[:, src:] = rng.uniform(0.9, 1.0, size=(B, m - src))
    bss = BatchedScenarioSolver(data, data["rhs"][None, :] * fac)
    ph1 = BatchedPhase1Solver(bss.blp, feasibility_tol=1e-4,
                              optimality_tol=1e-4, cr_maxiter=300,
                              cr64_maxiter=100)
    t0 = time.perf_counter()
    S = ph1._step_fn(ph1._ops_tree, ph1._start_fn(ph1._ops_tree, 0))
    np.asarray(S["X"])
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = ph1.solve(handoff="auto")
    wall = time.perf_counter() - t0
    return {"batched_stage_device": {
        "wall_s": round(wall, 3), "compile_s": round(compile_s, 3),
        "steps": int(out["iters"].max()), "cr_trips": int(out["cr"]),
        "done": int(out["done"].sum()), "B": B, "m": int(m)}}


def baseline_solve_time(data):
    """Same solve with native kernels disabled (pure scipy/python paths):
    the 'naive implementation' baseline."""
    code = r"""
import json, sys, time
sys.path.insert(0, %(repo)r)
import ipx_tpu.basis.lu as lu_mod
import ipx_tpu.kkt.normal_matrix as nm_mod
# disable native acceleration
lu_mod._load_lib = lambda: (_ for _ in ()).throw(RuntimeError("disabled"))
nm_mod._native_apply_handle = lambda model: None
import numpy as np
from ipx_tpu import LpSolver, Parameters
from ipx_tpu.testgen import transportation, load_into_solver
data = transportation(%(src)d, %(snk)d, %(dens)f, %(seed)d)
p = Parameters(); p.display = 0; p.device = "cpu"
s = LpSolver(p)
load_into_solver(data, s)
t0 = time.perf_counter()
status = s.solve()
print(json.dumps({"dt": time.perf_counter() - t0, "status": status}))
"""
    return code


def main():
    from ipx_tpu.ops.backend import get_jax
    jax = get_jax()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX runs on {dev.platform!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card()}
    # best-of-3 on BOTH sides of the headline comparison: host wall-clocks
    # swing run to run, and a single sample can move the ratio either way;
    # three draws per side keep the comparison symmetric while shrinking
    # the noise band
    t_solve, data, stats = full_solve()
    for _ in range(2):
        t_again, _, _ = full_solve()
        t_solve = min(t_solve, t_again)
    highs_ipm_s, highs_status = highs_solve_time(data, "highs-ipm")
    for _ in range(2):
        h_again, _ = highs_solve_time(data, "highs-ipm")
        highs_ipm_s = min(highs_ipm_s, h_again)
    highs_ds_s, _ = highs_solve_time(data, "highs-ds")
    # large-instance ratio (BASELINE.md's stated target regime): m=100k
    # transportation, same comparator
    try:
        t_large, data_large, _ = full_solve(40000, 60000, 1, density=2e-4)
        highs_large_s, _ = highs_solve_time(data_large, "highs-ipm")
        large_ratio = round(highs_large_s / t_large, 3)
        data_large = None
    except Exception:
        t_large, highs_large_s, large_ratio = None, None, None
    host_rate = host_matvec_rate(data)
    native_rate = native_matvec_rate(data)
    dev = device_matvec_rates(jax, 8000, 12000, 1)
    stage = batched_stage_metrics()

    # naive baseline: the pure-python compute paths are orders of magnitude
    # slower, so measure naive vs accelerated on a reduced instance that the
    # naive paths can finish (~16 s at m=750), and report that ratio as
    # vs_baseline (speedup of the framework's native/vectorized paths over a
    # naive implementation of the same algorithm).
    small = dict(src=300, snk=450, dens=0.01, seed=1)
    code = baseline_solve_time(None) % {"repo": REPO, **small}
    naive_dt = None
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=400)
        for line in out.stdout.strip().splitlines()[::-1]:
            if line.startswith("{"):
                naive_dt = json.loads(line)["dt"]
                break
    except Exception:
        pass
    # accelerated run of the same small instance
    from ipx_tpu import LpSolver, Parameters
    from ipx_tpu.testgen import transportation, load_into_solver
    sdata = transportation(small["src"], small["snk"], small["dens"],
                           small["seed"])
    p = Parameters()
    p.display = 0
    p.device = "cpu"
    s = LpSolver(p)
    load_into_solver(sdata, s)
    t0 = time.perf_counter()
    s.solve()
    accel_small_dt = time.perf_counter() - t0
    naive_speedup = (naive_dt / accel_small_dt) if naive_dt else 1.0

    result = {
        "metric": "full_solve_transportation_20k_rows",
        "value": round(t_solve, 3),
        "unit": "seconds (m=20k rows, n~96k cols, 2-phase IPM + crossover)",
        # wall-clock ratio vs C++ CPU IPX (HiGHS highs-ipm = HiGHS presolve
        # + embedded reference IPX + crossover) on the SAME instance;
        # > 1 means this framework is faster than the reference
        "vs_baseline": round(highs_ipm_s / t_solve, 3),
        "extra": {
            "solve_status": list(stats),
            "highs_ipm_s": round(highs_ipm_s, 3),
            "highs_ipm_status": highs_status,
            "highs_dual_simplex_s": round(highs_ds_s, 3),
            "full_solve_100k_rows_s": (round(t_large, 3)
                                       if t_large else None),
            "highs_ipm_100k_s": (round(highs_large_s, 3)
                                 if highs_large_s else None),
            "vs_baseline_100k_rows": large_ratio,
            "host_matvec_per_s": round(host_rate, 1),
            "native_matvec_per_s": round(native_rate, 1),
            "device": device,
            "device_f32_matvec_per_s": round(dev["f32_rate"], 1),
            "device_f32_compile_s": round(dev["f32_compile_s"], 1),
            "device_f64_matvec_per_s": round(dev["f64_rate"], 1),
            # per-vector-equivalent rate of the batched (B=256) device
            # normal-matrix apply — the scenario-batch hot op; compare to
            # native_matvec_per_s (host best per-vector throughput)
            "device_f32_batched256_matvec_per_s": round(
                dev["f32_batched256_rate"], 1),
            "device_vs_host_batched": round(
                dev["f32_batched256_rate"] / native_rate, 2),
            **stage,
            "naive_small_solve_s": round(naive_dt, 3) if naive_dt else None,
            "accel_small_solve_s": round(accel_small_dt, 3),
            "vs_naive_python": round(naive_speedup, 2),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
