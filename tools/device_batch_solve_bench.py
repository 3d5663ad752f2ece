"""Full batched scenario phase-1 solve at reference scale.

Runs the ENTIRE jitted batched predictor-corrector IPM (parallel/batch.py)
on the default JAX device (placement follows JAX_PLATFORMS) over B
perturbed-RHS scenarios of a transportation LP at m=20k..100k, and reports
scenarios/s, IPM iterations/s and CR matvec throughput (lane-equivalents/s)
as one JSON line naming the platform, device kind and device count.

This is the measurement BASELINE.md asks for ("IPM iterations/s and CR
matvecs/s" at chip scale): the whole phase-1 solve — starting point,
predictor-corrector steps, batched-CR KKT solves, convergence masks — is
device code; the host loop only dispatches steps and polls the done mask.

Methodology: programs take the operand pytree as a jit ARGUMENT (no data
constants in the compiled program); warm-up runs compile both programs
before the timed run; per-step wall-clocks include the per-step done-mask
sync that the production pipeline performs. On the CPU backend use
--maxsteps to bound the run and project from the steady-state per-step
time (the trajectory is step-for-step the same math at the same
tolerance).

Usage:
    python tools/device_batch_solve_bench.py --B 256
    JAX_PLATFORMS=cpu python tools/device_batch_solve_bench.py --B 256 \
        --maxsteps 6
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=int, default=8000)
    ap.add_argument("--snk", type=int, default=12000)
    ap.add_argument("--density", type=float, default=0.001)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--cr-maxiter", type=int, default=500)
    ap.add_argument("--cr64-maxiter", type=int, default=None,
                    help="budget for the f64 defect-correction finish "
                    "(bounds the per-step execution time)")
    ap.add_argument("--maxsteps", type=int, default=0,
                    help="0 = run to convergence (or 100-iteration cap)")
    ap.add_argument("--handoff", action="store_true",
                    help="stop at the diag-era handoff point (the "
                    "production pipeline rule) instead of convergence")
    args = ap.parse_args()

    import numpy as np
    from ipx_tpu.ops.backend import get_jax
    jax = get_jax()
    dev = jax.devices()[0]

    import ipx_tpu.testgen as tg
    from ipx_tpu.parallel.batch import BatchedScenarioSolver

    data = tg.transportation(args.src, args.snk, args.density, args.seed)
    m = data["num_constr"]
    ns = args.src                  # rows [0, ns) are '<' supplies, rest '>='
    rng = np.random.default_rng(0)
    B = args.B
    # feasibility-preserving perturbations (examples/batch_scenarios_1000.py)
    fac = np.empty((B, m))
    fac[:, :ns] = rng.uniform(1.0, 1.1, size=(B, ns))
    fac[:, ns:] = rng.uniform(0.9, 1.0, size=(B, m - ns))
    b_batch = data["rhs"][None, :] * fac

    bss = BatchedScenarioSolver(data, b_batch, phase2_polish=False,
                                phase1_tol=args.tol)
    from ipx_tpu.parallel.batch import BatchedPhase1Solver
    t0 = time.perf_counter()
    ph1 = BatchedPhase1Solver(bss.blp, feasibility_tol=args.tol,
                              optimality_tol=args.tol,
                              cr_maxiter=args.cr_maxiter, maxiter=100,
                              cr64_maxiter=args.cr64_maxiter)
    setup_s = time.perf_counter() - t0
    jnp = jax.numpy

    # ---- warm-up: compile the starting-point and step programs ----------
    t0 = time.perf_counter()
    S = ph1._start_fn(ph1._ops_tree, 0)
    jax.block_until_ready(S["X"])
    compile_start_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    S = ph1._step_fn(ph1._ops_tree, S)      # donates S
    jax.block_until_ready(S["X"])
    compile_step_s = time.perf_counter() - t0
    del S

    # ---- timed run from a fresh starting point --------------------------
    maxsteps = args.maxsteps if args.maxsteps > 0 else 100
    budget = ph1.step_cr_budget()
    t_run0 = time.perf_counter()
    S = ph1._start_fn(ph1._ops_tree, 0)
    bool(jnp.all(S["done"]))
    t_start_s = time.perf_counter() - t_run0
    step_times = []
    steps = 0
    converged = False
    handoff = False
    prev_cr = int(S["cr"])
    saturated = 0
    while steps < maxsteps:
        t1 = time.perf_counter()
        S = ph1._step_fn(ph1._ops_tree, S)
        done = bool(jnp.all(S["done"]))     # per-step sync (pipeline does this)
        step_times.append(time.perf_counter() - t1)
        steps += 1
        mu = np.asarray(S["mu"])
        cr = int(S["cr"])
        print(f"# step {steps}: {step_times[-1]:.2f}s cr={cr} "
              f"done={int(np.sum(np.asarray(S['done'])))} "
              f"mu_med={np.median(mu):.2e} mu_max={mu.max():.2e}",
              file=sys.stderr, flush=True)
        if done:
            converged = True
            break
        # production handoff rule (BatchedPhase1Solver.solve): stop once
        # the CR budget saturates twice in a row — the diag era is over
        if args.handoff:
            saturated = saturated + 1 if cr - prev_cr >= 0.8 * budget else 0
            prev_cr = cr
            if saturated >= 2:
                handoff = True
                break
    wall_s = time.perf_counter() - t_run0
    cr_trips = int(S["cr"])
    iters = np.asarray(S["iters"])
    done_count = int(np.sum(np.asarray(S["done"])))
    med_step = float(np.median(step_times[1:])) if len(step_times) > 1 \
        else float(step_times[0])

    out = {
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "m": int(m), "n": int(data["num_var"]), "B": B,
        "tol": args.tol,
        "steps": steps,
        "converged_all": converged,
        "handoff": handoff,
        "mu_med_final": float(np.median(np.asarray(S["mu"]))),
        "done_count": done_count,
        "mean_ipm_iters": round(float(iters.mean()), 2),
        "cr_trips": cr_trips,
        "setup_s": round(setup_s, 2),
        "compile_start_s": round(compile_start_s, 2),
        "compile_step_s": round(compile_step_s, 2),
        "start_s": round(t_start_s, 3),
        "wall_s": round(wall_s, 3),
        "median_step_s": round(med_step, 4),
        "steps_s": [round(t, 3) for t in step_times[:3]],
        # lane-equivalent CR matvec throughput: each CR trip applies the
        # batched normal matrix over all B scenario lanes
        "cr_matvec_lane_equiv_per_s": round(cr_trips * B / wall_s, 1),
        "ipm_iters_per_s": round(float(iters.sum()) / wall_s, 2),
        "scenarios_per_s": (round(B / wall_s, 2) if converged else None),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
