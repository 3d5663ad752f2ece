"""BASELINE-scale scenario batch: 1024 perturbed-RHS LPs end to end.

Pipeline (SURVEY §2.3 data-parallel analog; no reference counterpart):
  1. batched phase-1 IPM over all scenarios at once (one jitted
     predictor-corrector program, per-scenario convergence masks,
     diag-era handoff),
  2. per-scenario warm-started finishes to vertex (basic) solutions
     (shared mean-scenario starting basis).

The round-4 version inserted a shared-basis batched polish between the
stages; round-5 measurements showed it costs more per scenario than the
finishes it saves (docs/PERFORMANCE.md), and dropping it made this
example 11.9x faster end to end. Each finished objective is
cross-checked against an independent direct solve for a sample. Run:

    python examples/batch_scenarios_1000.py

(placement follows JAX_PLATFORMS; JAX_PLATFORMS=cpu runs it on the host).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    from ipx_tpu import LpSolver, Parameters
    from ipx_tpu.parallel.batch import BatchedScenarioSolver
    import ipx_tpu.testgen as tg

    data = tg.transportation(60, 90, 0.05, seed=2)
    m = data["num_constr"]
    ns = 60                      # rows [0, ns) are '<' supplies, rest '>='
    rng = np.random.default_rng(0)
    B = 1024
    # feasibility-preserving perturbations: supplies scale up, demands
    # scale down (a random +/-10% of every row can exceed total supply)
    fac = np.empty((B, m))
    fac[:, :ns] = rng.uniform(1.0, 1.1, size=(B, ns))
    fac[:, ns:] = rng.uniform(0.9, 1.0, size=(B, m - ns))
    b_batch = data["rhs"][None, :] * fac

    t0 = time.perf_counter()
    # A shallow batched sweep: on the CPU backend the batched phase 1 is
    # compile/width-bound, so the demo runs it to a loose tolerance and
    # lets the warm-started finishes close the gap. On a GPU deepen it
    # (phase1_tol=1e-4 default) and the finishes become trivial.
    # phase2_polish stays OFF (round-5 default): the shared-basis polish
    # costs more per scenario than the per-lane finishes it would save
    # (measured, docs/PERFORMANCE.md round-5 section)
    solver = BatchedScenarioSolver(data, b_batch, phase1_tol=3e-3,
                                   phase1_maxiter=12)
    from ipx_tpu.parallel.batch import BatchedPhase1Solver
    ph1 = BatchedPhase1Solver(solver.blp, feasibility_tol=solver.phase1_tol,
                              optimality_tol=solver.phase1_tol,
                              maxiter=solver.phase1_maxiter)
    out = ph1.solve(handoff="auto")
    t1 = time.perf_counter()
    print(f"batched phase 1: {t1 - t0:.1f}s "
          f"(converged {int(np.asarray(out['done']).sum())}/{B} at tol "
          f"{solver.phase1_tol:g})", flush=True)
    if solver.phase2_polish:
        out = solver._polish(out)
        print(f"shared-basis polish: {time.perf_counter() - t1:.1f}s",
              flush=True)
    t2 = time.perf_counter()
    results = solver._finish(out)
    print(f"per-scenario finishes: {time.perf_counter() - t2:.1f}s",
          flush=True)
    dt = time.perf_counter() - t0

    statuses = np.array([r[0] for r in results])
    ipm_status = np.array([r[1].status_ipm for r in results])
    iters = np.array([r[1].iter for r in results])
    objs = np.array([r[1].pobjval for r in results])
    print(f"\n{B} scenarios in {dt:.1f}s "
          f"({dt / B * 1000:.0f} ms/scenario incl. batched phases)")
    print(f"statuses: {int((statuses == 1000).sum())}/{B} solved, "
          f"{int((ipm_status == 1).sum())}/{B} optimal verdicts")
    print(f"finish IPM iterations: mean {iters.mean():.2f}, "
          f"p90 {np.percentile(iters, 90):.0f}, max {iters.max()}")
    print(f"objectives: min {objs.min():.4f} max {objs.max():.4f}")

    # cross-check a sample against independent direct solves
    sample = rng.choice(B, size=8, replace=False)
    worst = 0.0
    for k in sample:
        p = Parameters()
        p.display = 0
        s = LpSolver(p)
        tg.load_into_solver({**data, "rhs": b_batch[k]}, s)
        assert s.solve() == 1000
        assert s.get_info().status_ipm == 1, int(k)
        assert ipm_status[k] == 1, int(k)
        ref = s.get_info().pobjval
        worst = max(worst, abs(objs[k] - ref) / max(1.0, abs(ref)))
    print(f"sampled objective check vs direct solves: max rel diff "
          f"{worst:.2e}")
    assert worst < 1e-6


if __name__ == "__main__":
    main()
