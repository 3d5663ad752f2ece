"""Multi-chip sharded solve: one LP spanning a device mesh.

`Parameters.shards = k` partitions the constraint rows of AI = [A I] into
k blocks over a `jax.sharding` mesh and runs BOTH interior-point phases
with mesh collectives:

  * phase 1: the normal-matrix products of the diagonal-preconditioned CR
    as psum-reduced block SpMVs (ipx_tpu/parallel/sharding.py
    ShardedDiagCR);
  * phase 2: the splitted-normal NN' product column-sharded with a psum
    assembling the full product (ShardedSplittedNNt), with the B/B'
    triangular solves on host.

On a host with four GPUs it runs as it stands. Without them, force a
virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_solve.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    from ipx_tpu import LpSolver, Parameters
    import ipx_tpu.testgen as tg

    data = tg.transportation(1000, 1500, 0.005, seed=3)
    m = data["num_constr"]

    # reference solve, single device
    p0 = Parameters()
    p0.display = 0
    p0.device = "cpu"
    s0 = LpSolver(p0)
    tg.load_into_solver(data, s0)
    t0 = time.perf_counter()
    assert s0.solve() == 1000
    t_single = time.perf_counter() - t0
    ref_obj = s0.get_info().pobjval

    # sharded solve over 4 mesh devices
    p = Parameters()
    p.display = 0
    p.shards = 4
    s = LpSolver(p)
    tg.load_into_solver(data, s)
    t0 = time.perf_counter()
    status = s.solve()
    t_sharded = time.perf_counter() - t0
    info = s.get_info()
    nnt = getattr(s.model, "_sharded_nnt", None)

    print(f"m={m}: single-device {t_single:.2f}s, "
          f"sharded(4) {t_sharded:.2f}s (incl. mesh compile)")
    print(f"status={status} objective={info.pobjval:.6f} "
          f"(reference {ref_obj:.6f}, "
          f"rel diff {abs(info.pobjval - ref_obj) / abs(ref_obj):.2e})")
    print(f"phase-1 mesh CR iterations: {info.kktiter1}; "
          f"phase-2 mesh NN' applies: "
          f"{nnt[1].applies if nnt else 0}")
    assert status == 1000
    assert abs(info.pobjval - ref_obj) <= 1e-7 * abs(ref_obj)
    print("OK")


if __name__ == "__main__":
    main()
