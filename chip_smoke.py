"""Runs the solver's device path on one GPU through the public entry points
and checks every result against a plain reference.

    python chip_smoke.py          # one GPU: phases 1-5 below
    python chip_smoke.py --four   # four GPUs: the sharded solve only

Phases (one GPU):
  1. device, card (name and power limit from nvidia-smi), native build key;
  2. the take + segment_sum SpMV against scipy's f64 product, at B=1 and
     B=256, on the transportation LPs m=20k and m=100k;
  3. one m=100k LP through LpSolver(device="gpu"): presolve, phase-1 device
     CR, phase-2 device NN', crossover; checked against the host path and
     HiGHS; then precision="f64" and device="auto" once each;
  4. a B=256 scenario fleet of the m=20k LP: batched phase 1 on the card,
     then 16 lanes finished to vertices and 4 checked against direct
     solves;
  5. the tests marked `chip`, in this process.

Every phase asserts; any failure exits nonzero. Without a GPU (or outside a
checkout of the repository) it exits nonzero and prints no result. The last
line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# m=100k and m=20k transportation LPs: (sources, sinks, density, seed)
M100K = (40000, 60000, 2e-4, 1)
M20K = (8000, 12000, 1e-3, 1)


def log(*args):
    print(*args, flush=True)


def native_library():
    """This host's native library path and whether it existed before this
    run. Read through build.py alone: importing the package builds it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ipxlu_build", os.path.join(REPO, "ipx_tpu", "native", "build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = build.library_path()
    return lib, os.path.exists(lib)


def card() -> str:
    """Name and power limit of the card, read by nvidia-smi in a child
    process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


class CompileTimer:
    """Sums JAX's trace, lowering and compile durations (set-up time), in
    all and per jitted function, and counts backend compiles, through
    jax.monitoring."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self, jax):
        self.seconds = 0.0
        self.compiles = 0
        self.by_fun = {}
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, seconds, fun_name="", **kw):
        if name in self.EVENTS:
            self.seconds += seconds
            self.compiles += name.endswith("backend_compile_duration")
            fun = fun_name[4:-1] if fun_name.startswith("jit(") \
                else fun_name
            self.by_fun[fun] = self.by_fun.get(fun, 0.0) + seconds


def transportation(args):
    from ipx_tpu.testgen import transportation as gen
    return gen(*args[:3], seed=args[3])


def csc(data):
    import scipy.sparse as sp
    return sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]),
                         shape=(data["num_constr"], data["num_var"]))


def solve(data, **params):
    from ipx_tpu import LpSolver, Parameters
    from ipx_tpu.testgen import load_into_solver
    p = Parameters()
    p.display = 0
    for k, v in params.items():
        setattr(p, k, v)
    s = LpSolver(p)
    load_into_solver(data, s)
    t0 = time.perf_counter()
    status = s.solve()
    return s, status, time.perf_counter() - t0


def rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def highs_objective(data) -> float:
    """Objective of scipy's HiGHS interior point method (crossover on)."""
    import scipy.sparse as sp
    from scipy.optimize import linprog
    A = csc(data)
    ct = np.array(list(data["constr_type"]))
    rhs = data["rhs"]
    lt, gt, eq = ct == "<", ct == ">", ct == "="
    A_ub = sp.vstack([A[np.nonzero(lt)[0]], -A[np.nonzero(gt)[0]]])
    b_ub = np.concatenate([rhs[lt], -rhs[gt]])
    res = linprog(data["obj"], A_ub=A_ub, b_ub=b_ub,
                  A_eq=A[np.nonzero(eq)[0]] if eq.any() else None,
                  b_eq=rhs[eq] if eq.any() else None,
                  bounds=np.stack([data["lb"], data["ub"]], axis=1),
                  method="highs-ipm")
    assert res.status == 0, res.message
    return float(res.fun)


def info_line(s, wall):
    i = s.get_info()
    return (f"status {i.status} ipm {i.status_ipm} crossover "
            f"{i.status_crossover} obj {i.pobjval!r} iter {i.iter} "
            f"kktiter1 {i.kktiter1} kktiter2 {i.kktiter2} | wall {wall:.3f}s "
            f"ipm1 {i.time_ipm1:.3f}s ipm2 {i.time_ipm2:.3f}s crossover "
            f"{i.time_crossover:.3f}s cr1 {i.time_cr1:.3f}s cr2 "
            f"{i.time_cr2:.3f}s cr2_NNt {i.time_cr2_NNt:.3f}s")


def assert_vertex(s, status, what):
    i = s.get_info()
    assert status == 1000, f"{what}: status {status}"
    assert i.status_crossover == 1, f"{what}: crossover {i.status_crossover}"
    assert s.get_basic_solution() is not None, f"{what}: no basic solution"


# ----------------------------------------------------------------------
def phase_spmv(jax):
    """Phase 2: SpMV against scipy's f64 product. The error is relative to
    |A| W |A'| |v|; the tolerances allow for rounding in another order
    than scipy's (segment_sum is a scatter-add on the GPU, whose order of
    summation can change from run to run)."""
    jnp = jax.numpy
    from ipx_tpu.ops.spmv import NormalMatrixDevice
    tol = {np.float64: 1e-12, np.float32: 1e-5}
    for name, args in (("m20k", M20K), ("m100k", M100K)):
        A = csc(transportation(args))
        m, n = A.shape
        absA = abs(A)
        rng = np.random.default_rng(0)
        for B in (1, 256):
            shape = (m,) if B == 1 else (m, B)
            W = 10.0 ** rng.uniform(-3, 3, size=(n + m,) + shape[1:])
            V = rng.standard_normal(shape)
            Ws, Wl = W[:n], W[n:]
            ref = A @ (Ws * (A.T @ V)) + Wl * V
            scale = absA @ (Ws * (absA.T @ np.abs(V))) + Wl * np.abs(V)
            for dt in (np.float64, np.float32):
                nmd = NormalMatrixDevice(A, dtype=dt)
                fn = jax.jit(nmd.apply_batched)
                Wd, Vd = jnp.asarray(W, dt), jnp.asarray(V, dt)
                out = np.asarray(fn(Wd, Vd), dtype=np.float64)
                err = float(np.max(np.abs(out - ref) / scale))
                reps = 20
                t0 = time.perf_counter()
                for _ in range(reps):
                    o = fn(Wd, Vd)
                jax.block_until_ready(o)
                us = (time.perf_counter() - t0) / reps * 1e6
                log(f"spmv {name} nnz {A.nnz} B={B} {np.dtype(dt).name}: "
                    f"rel err {err:.3e} (tol {tol[dt]:g}), "
                    f"{us:.1f} us per normal apply")
                assert err <= tol[dt], (name, B, dt, err)


def phase_single_lp(timer):
    """Phase 3: one m=100k LP end to end."""
    data = transportation(M100K)
    log(f"single LP: transportation m={data['num_constr']} "
        f"n={data['num_var']} nnz={len(data['Ax'])}")
    host, st, wall = solve(data, device="cpu")
    assert_vertex(host, st, "host")
    log("host   " + info_line(host, wall))
    ref = host.get_info().pobjval
    t0 = time.perf_counter()
    highs = highs_objective(data)
    log(f"HiGHS ipm objective {highs!r} ({time.perf_counter() - t0:.3f}s)")

    from ipx_tpu.ops.device_cr import cr_program
    results = {}
    for precision in ("mixed", "f64"):
        c0, n0 = timer.seconds, timer.compiles
        cr0 = timer.by_fun.get("cr", 0.0)
        programs = cr_program()._cache_size()
        s, st, wall = solve(data, device="gpu", precision=precision)
        assert_vertex(s, st, f"gpu {precision}")
        log(f"gpu {precision:5s} " + info_line(s, wall))
        log(f"  set-up: {timer.compiles - n0} compiles, "
            f"{timer.seconds - c0:.3f}s tracing and compiling (in wall)")
        obj = s.get_info().pobjval
        assert rel(obj, ref) <= 1e-8, (precision, obj, ref)
        assert rel(obj, highs) <= 1e-7, (precision, obj, highs)
        assert cr_program()._cache_size() == programs + 1, \
            "phase-1 device CR compiled other than once"
        dcr2 = s.model._device_cr2
        assert dcr2.applies > 0, "phase-2 device NN' never ran"
        assert dcr2._fn._cache_size() == 1, "phase-2 program recompiled"
        log(f"  phase-1 device CR: 1 program, {s.get_info().kktiter1} "
            f"iterations; phase-2 device NN': {dcr2.applies} applies, "
            f"1 program")
        # phase-1 CR wall without the CR program's trace and compile
        results[precision] = s.get_info().time_cr1 \
            - (timer.by_fun.get("cr", 0.0) - cr0)
    log(f"finding: phase-1 CR wall at m=100k, compile excluded: mixed "
        f"{results['mixed']:.3f}s, f64 {results['f64']:.3f}s")

    s, st, wall = solve(data, device="auto")
    assert_vertex(s, st, "auto")
    md = s.model
    p1 = "device" if hasattr(md, "_normal_device32") else "host"
    p2 = "device" if getattr(md, "_device_cr2", None) is not None \
        else "host"
    log(f"auto   " + info_line(s, wall))
    log(f"  auto took phase 1 on the {p1}, phase 2 on the {p2}")
    assert rel(s.get_info().pobjval, ref) <= 1e-8


def phase_fleet(jax, dev):
    """Phase 4: B=256 scenario fleet of the m=20k LP."""
    from ipx_tpu.parallel.batch import (BatchedPhase1Solver,
                                        BatchedScenarioSolver)
    data = transportation(M20K)
    m, ns = data["num_constr"], M20K[0]
    rng = np.random.default_rng(0)
    B = 256
    # feasibility-preserving perturbations: supplies ('<' rows) scale up,
    # demands ('>' rows) scale down
    fac = np.empty((B, m))
    fac[:, :ns] = rng.uniform(1.0, 1.1, size=(B, ns))
    fac[:, ns:] = rng.uniform(0.9, 1.0, size=(B, m - ns))
    b_batch = data["rhs"][None, :] * fac

    fleet = BatchedScenarioSolver(data, b_batch)
    ph1 = BatchedPhase1Solver(fleet.blp, feasibility_tol=fleet.phase1_tol,
                              optimality_tol=fleet.phase1_tol,
                              maxiter=fleet.phase1_maxiter)
    t0 = time.perf_counter()
    out = ph1.solve(handoff="auto")
    wall = time.perf_counter() - t0
    done = int(out["done"].sum())
    assert np.all(np.isfinite(out["X"])) and np.all(np.isfinite(out["Y"]))
    log(f"fleet phase 1: B={B} m={m} cr_dtype {ph1.cr_dtype}: "
        f"{int(out['iters'].max())} steps, {int(out['cr'])} CR trips, "
        f"{done}/{B} lanes converged at tol {fleet.phase1_tol:g}, "
        f"{wall:.3f}s (compile included)")

    lanes = 16
    sub = BatchedScenarioSolver(data, b_batch[:lanes])
    t0 = time.perf_counter()
    results = sub.solve()
    wall = time.perf_counter() - t0
    solved = sum(r[0] == 1000 for r in results)
    log(f"fleet finishes: {solved}/{lanes} lanes at vertices, {wall:.3f}s")
    assert solved == lanes
    for k in range(4):
        direct, st, _ = solve({**data, "rhs": b_batch[k]}, device="cpu")
        assert st == 1000
        r = rel(results[k][1].pobjval, direct.get_info().pobjval)
        log(f"  lane {k}: objective {results[k][1].pobjval!r}, "
            f"direct {direct.get_info().pobjval!r}, rel diff {r:.2e}")
        assert r <= 1e-7, (k, r)
    log(f"peak device memory: {dev.memory_stats()['peak_bytes_in_use']} B")


def phase_chip_tests():
    """Phase 5: the tests marked `chip`, in this process (one process per
    card: a second JAX process could not reserve the card's memory)."""
    import pytest
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(REPO, "tests")])
    assert rc == 0, f"chip tests failed (pytest exit code {rc})"


def phase_four(jax):
    """--four: Parameters.shards=4 on the m=100k LP against the one-card
    solve, and the batched CR on a (rows=2, batch=2) mesh."""
    from jax.sharding import Mesh
    from ipx_tpu.parallel.sharding import (ShardedNormalMatrix,
                                           sharded_batched_cr_solve)
    assert len(jax.devices()) >= 4, "--four needs four GPUs"
    data = transportation(M100K)
    one, st, wall = solve(data, device="gpu")
    assert_vertex(one, st, "one card")
    log("1 card   " + info_line(one, wall))
    four, st, wall = solve(data, shards=4)
    assert_vertex(four, st, "shards=4")
    log("shards=4 " + info_line(four, wall))
    r = rel(four.get_info().pobjval, one.get_info().pobjval)
    log(f"  objective rel diff to one card: {r:.2e}")
    assert r <= 1e-8, r
    nnt = four.model._sharded_nnt[1]
    assert nnt.applies > 0, "sharded phase-2 NN' never ran"
    assert four.get_info().kktiter1 > 0
    log(f"  sharded phase-2 NN' applies: {nnt.applies}")

    A = csc(transportation(M20K))
    m, n = A.shape
    B = 8
    rng = np.random.default_rng(1)
    W = 10.0 ** rng.uniform(-2, 2, size=(n + m, B))
    A2 = A.copy()
    A2.data = A2.data ** 2
    diag = np.asarray(A2 @ W[:n]) + W[n:]
    RHS = rng.standard_normal((m, B))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                axis_names=("rows", "batch"))
    snm = ShardedNormalMatrix(A, num_blocks=2)
    t0 = time.perf_counter()
    Y, iters = sharded_batched_cr_solve(snm, W[:n], W[n:], diag, RHS,
                                        tol=1e-8, maxiter=20000, mesh=mesh)
    wall = time.perf_counter() - t0
    worst = 0.0
    for k in range(B):
        w, y, rhs = W[:, k], Y[:, k], RHS[:, k]
        res = rhs - (A @ (w[:n] * (A.T @ y)) + w[n:] * y)
        worst = max(worst, np.max(np.abs(res)) / max(1.0, np.abs(rhs).max()))
    log(f"2x2 mesh batched CR: m={m} B={B}, {iters} iterations, "
        f"max rel residual {worst:.2e}, {wall:.3f}s (compile included)")
    assert worst <= 1e-6, worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU sharded path only")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "ipx_tpu")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, REPO)
    lib, existed = native_library()

    from ipx_tpu.ops.backend import get_jax
    jax = get_jax()
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU found: JAX runs on {dev.platform!r}")
    log(f"device: platform {dev.platform}, kind {dev.device_kind}, "
        f"count {len(devices)}")
    log(f"card: {card()}")
    timer = CompileTimer(jax)

    if args.four:
        phase_four(jax)
        count = 4
    else:
        from ipx_tpu.native import build
        assert build.build() == lib
        log(f"native library: key {os.path.basename(os.path.dirname(lib))}"
            f", {'reused' if existed else 'built by this run'} ({lib})")
        phase_spmv(jax)
        phase_single_lp(timer)
        phase_fleet(jax, dev)
        phase_chip_tests()
        count = len(devices)
    log(f"set-up over the run: {timer.compiles} compiles, "
        f"{timer.seconds:.3f}s tracing and compiling")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))


if __name__ == "__main__":
    main()
