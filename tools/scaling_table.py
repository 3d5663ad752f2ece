"""CPU-mesh scaling table for the row-sharded phase-1 CR (VERDICT r4
item 7; BASELINE.md "scaling efficiency at 1 chip, 1 host, N hosts").

Runs ShardedDiagCR (the Parameters.shards mesh path: shard_map + psum
over a row-block mesh) at 1/2/4/8 devices of the default backend (as many
as it has) on a fixed m=20k normal-equations system with a FIXED
iteration count, and writes docs/SCALING.tbl.

On virtual CPU devices the devices SHARE the host's cores, so total
arithmetic is constant across mesh sizes and the ratio t_d / t_1 isolates
the partition + collective overhead of the sharded program (the quantity
that eats scaling efficiency on real multi-device meshes, where
per-device arithmetic additionally shrinks by 1/d).

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       JAX_PLATFORMS=cpu python tools/scaling_table.py
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)



def main():
    import numpy as np
    from ipx_tpu.ops.backend import get_jax
    jax = get_jax()
    import scipy.sparse as sp
    from ipx_tpu.testgen import transportation
    from ipx_tpu.parallel.sharding import ShardedDiagCR

    data = transportation(8000, 12000, 0.001, 1)
    m, n = data["num_constr"], data["num_var"]
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]), shape=(m, n))
    rng = np.random.default_rng(0)
    W = rng.uniform(0.5, 2.0, size=n + m)
    A2 = A.copy()
    A2.data = A2.data ** 2
    diag = np.asarray(A2 @ W[:n]).ravel() + W[n:]
    rhs = rng.standard_normal(m)
    resscale = 1.0 / np.sqrt(W[n:])
    ITERS = 200

    from jax.sharding import Mesh
    devs = jax.devices()
    dev = devs[0]
    rows = []
    t1 = None
    for d in (d for d in (1, 2, 4, 8) if d <= len(devs)):
        mesh = Mesh(np.array(devs[:d]), ("rows",))
        cr = ShardedDiagCR(A, d, mesh=mesh)
        # warm-up (compile)
        cr.solve(W[:n], W[n:], diag, resscale, rhs, 0.0, 5)
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            y, iters, err = cr.solve(W[:n], W[n:], diag, resscale, rhs,
                                     0.0, ITERS)
            dt = time.perf_counter() - t0
            assert iters == ITERS, (iters, err)
            best = dt if best is None else min(best, dt)
        mv = ITERS / best
        if t1 is None:
            t1 = best
        rows.append((d, best, mv, best / t1))
        print(f"devices={d}: {best:.2f}s {mv:.1f} matvec/s "
              f"overhead x{best / t1:.2f}", flush=True)

    lines = ["# Row-sharded phase-1 CR over a device mesh "
             "(tools/scaling_table.py)",
             f"# devices: {dev.platform} {dev.device_kind}",
             f"# m={m} n={n} nnz={A.nnz} fixed {ITERS} CR iterations, "
             "best of 3",
             "# NOTE: virtual CPU devices share the host's cores - total",
             "# arithmetic is constant across mesh sizes, so t_d/t_1",
             "# isolates partition+collective overhead (on real devices",
             "# per-device arithmetic additionally shrinks by 1/d).",
             f"{'devices':>8s} {'wall_s':>8s} {'matvec/s':>10s} "
             f"{'t_d/t_1':>8s}"]
    for d, dt, mv, ratio in rows:
        lines.append(f"{d:>8d} {dt:>8.2f} {mv:>10.1f} {ratio:>8.2f}")
    out = os.path.join(REPO, "docs", "SCALING.tbl")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote", out)


if __name__ == "__main__":
    main()
