"""Device solve: both interior-point phases' CR products on the GPU.

`Parameters.device = "gpu"` routes

  * the phase-1 diagonal-preconditioned CR as one jitted lax.while_loop
    (mixed precision: f32 device loop + f64 defect correction,
    ipx_tpu/ops/device_cr.py), and
  * the phase-2 basis-preconditioned CR with the NN' product as a jitted
    device program (ipx_tpu/ops/device_cr2.py)

while the sequential runtime (LU, maxvolume, crossover) stays on host.
Needs a GPU; device="gpu" raises DeviceError without one.

    python examples/device_solve.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    import jax
    from ipx_tpu import LpSolver, Parameters
    import ipx_tpu.testgen as tg

    print("backend device:", jax.devices()[0])
    data = tg.transportation(800, 1200, 0.01, seed=4)

    # host reference
    p0 = Parameters()
    p0.display = 0
    p0.device = "cpu"
    s0 = LpSolver(p0)
    tg.load_into_solver(data, s0)
    assert s0.solve() == 1000
    ref_obj = s0.get_info().pobjval

    p = Parameters()
    p.display = 0
    p.device = "gpu"
    s = LpSolver(p)
    tg.load_into_solver(data, s)
    t0 = time.perf_counter()
    status = s.solve()
    dt = time.perf_counter() - t0

    info = s.get_info()
    print(f"device solve: status={status} in {dt:.2f}s "
          f"(objective {info.pobjval:.6f}, host {ref_obj:.6f})")
    applies = s.model._device_cr2.applies
    print(f"phase-2 device NN' products: {applies} "
          f"({info.kktiter2} CR iterations)")
    assert status == 1000
    assert abs(info.pobjval - ref_obj) <= 1e-7 * abs(ref_obj)
    assert applies, "device phase-2 never engaged"
    print("OK")


if __name__ == "__main__":
    main()
