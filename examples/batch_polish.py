"""Scenario fleet with the shared-basis phase-2 polish.

Pipeline: batched diagonal-preconditioned phase 1 over all scenarios at
once -> one mean-scenario solve provides a basis -> the shared-basis
batched polish drives every scenario near complementarity with blocked
multi-RHS B/B' solves -> per-scenario warm-started finishes (phase 2 +
crossover). Run standalone:

    JAX_PLATFORMS=cpu python examples/batch_polish.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def main():
    from ipx_tpu import Parameters
    from ipx_tpu.parallel.batch import BatchedScenarioSolver
    from ipx_tpu.testgen import transportation

    data = transportation(80, 160, 0.05, seed=1)
    m = data["num_constr"]
    rng = np.random.default_rng(2)
    B = 8
    b_batch = data["rhs"][None, :] * rng.uniform(0.97, 1.06, size=(B, m))

    p = Parameters()
    p.display = 0
    p.device = "cpu"
    solver = BatchedScenarioSolver(data, b_batch, parameters=p,
                                   phase2_polish=True)
    results = solver.solve()
    ok = sum(1 for st, _, _ in results if st == 1000)
    finish_iters = sum(i.iter for _, i, _ in results)
    print(f"{B} scenarios solved to vertex optima: {ok}/{B} optimal, "
          f"{finish_iters} total finish IPM iterations")
    for k, (st, info, _) in enumerate(results[:4]):
        print(f"  scenario {k}: objective {info.objval:.6e}")


if __name__ == "__main__":
    main()
