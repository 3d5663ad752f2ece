"""ipx_tpu — interior-point LP solver with a JAX device path for GPUs.

A JAX/XLA implementation with the capabilities of the
ERGO-Code/ipx reference solver: a primal-dual Mehrotra predictor-corrector
interior-point method whose Newton/KKT step is solved by preconditioned
Conjugate Residuals on the normal equations AI*W*AI', with a diagonal
(+ dense-column SMW) preconditioner in early iterations and a basis-matrix
preconditioner (sparse LU + Forrest-Tomlin updates) in the main iterations,
followed by crossover to an optimal vertex basis.

Public API mirrors the reference LpSolver (reference: src/lp_solver.h:19-190)
plus a flat C-API-style function set in ipx_tpu.capi.
"""
import os as _os

# On small VMs the Linux scheduler can leave an OpenMP team timesharing ONE
# cpu (measured: 20x slowdown of every parallel region in the native
# kernels). Bind threads to distinct places unless the user set a policy.
# (The native library also sets this in a dlopen constructor; doing it here
# too covers the case where another extension initialized libgomp first.)
#
# Multi-process caveat (ADVICE r3): the setdefault is process-wide and
# affects every OpenMP runtime loaded into this process (numpy/MKL/...).
# When several solver processes share one machine (e.g. a multi-process
# batch driver), each spreads over the SAME places and can recreate the
# timesharing contention this targets — export distinct OMP_PLACES per
# worker in that configuration, or set OMP_PROC_BIND explicitly to
# override this default. Skipped when the user already pinned placement.
if not (_os.environ.get("OMP_PLACES") or _os.environ.get(
        "GOMP_CPU_AFFINITY")):
    _os.environ.setdefault("OMP_PROC_BIND", "spread")


def _tune_malloc() -> None:
    """Keep large allocations on the heap instead of per-allocation mmaps.

    The solver's hot path creates O(n+m)-sized temporaries every call;
    glibc serves those from mmap and returns them to the OS on free, so
    every reuse pays fresh page faults + kernel zeroing (measured 200-800ms
    per call of a ~25ms vector kernel at m=200k). Raising the mmap/trim
    thresholds makes the heap retain and reuse the pages."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass


_tune_malloc()

from .info import Info
from .lp_solver import LpSolver
from .ops.backend import DeviceError
from .parameters import Parameters
from .status import (Errflag, SolveStatus, Status,
                     IPX_BASIC, IPX_NONBASIC, IPX_NONBASIC_LB,
                     IPX_NONBASIC_UB, IPX_SUPERBASIC)
from .user_model import BasicSolution, InteriorSolution
from .version import __version__

__all__ = [
    "LpSolver", "Parameters", "Info", "Status", "SolveStatus", "Errflag",
    "DeviceError", "BasicSolution", "InteriorSolution", "__version__",
    "IPX_BASIC", "IPX_NONBASIC", "IPX_NONBASIC_LB", "IPX_NONBASIC_UB",
    "IPX_SUPERBASIC",
]
