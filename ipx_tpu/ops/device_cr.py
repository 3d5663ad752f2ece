"""On-device preconditioned Conjugate Residuals for the normal equations.

Device re-architecture of the phase-1 KKT solve (reference:
src/kkt_solver_diag.cc + src/conjugate_residuals.cc): the ENTIRE CR loop runs
as one jitted lax.while_loop on device, with the normal-matrix apply

    C v = A (W_struct * (A' v)) + W_slack * v

as take + segment_sum products (ipx_tpu.ops.spmv). Host<->device traffic
per solve is one rhs upload and one solution download.

Inner products are elementwise products followed by a sum, never f32 matrix
products: XLA may run an f32 dot in TF32 on the GPU (about 3 digits), while
the f32 inner solve relies on about 6 (F32_FLOOR).

Safeguards mirror the host CR (reference: src/conjugate_residuals.cc:90-213):
scaled inf-norm termination on the true residual, posdef checks via the fused
curvature dots, and the 5-iteration monotonicity recheck of the
preconditioned residual norm.
"""
from __future__ import annotations

from functools import partial
from time import perf_counter
from typing import Optional, Tuple

import numpy as np

from ..model import Model
from ..status import Errflag
from . import backend
from .backend import get_jax


# error codes inside the device loop
_OK = 0
_ITER_LIMIT = 1
_NOT_POSDEF = 2
_PRECOND_NOT_POSDEF = 3
_NO_PROGRESS = 4
_INF_NAN = 5

_ERRFLAG_MAP = {
    _OK: 0,
    _ITER_LIMIT: int(Errflag.CR_ITER_LIMIT),
    _NOT_POSDEF: int(Errflag.CR_MATRIX_NOT_POSDEF),
    _PRECOND_NOT_POSDEF: int(Errflag.CR_PRECOND_NOT_POSDEF),
    _NO_PROGRESS: int(Errflag.CR_NO_PROGRESS),
    _INF_NAN: int(Errflag.CR_INF_OR_NAN),
}


_program = None


def cr_program():
    """The jitted CR solve that every model shares (built once)."""
    global _program
    if _program is None:
        _program = _build_cr_fn(get_jax())
    return _program


def _build_cr_fn(jax):
    """Builds the jitted CR solve over the SpMV operands
    (NormalMatrixDevice.tree). dtype follows the operand / input arrays
    (f64, or f32 for the mixed-precision inner solve). The operand arrays
    arrive through the `dev` pytree ARGUMENT rather than a closure, so the
    compiled program carries no data constants, and the structural column
    count n is static: one compiled program serves every model of a shape
    and dtype."""
    jnp = jax.numpy
    lax = jax.lax
    from .spmv import normal_apply

    def cr(dev, W, diag, resscale, rhs, tol, maxiter, *, n):
        m = rhs.shape[0]
        inv_diag = 1.0 / diag

        def C(v):
            out = normal_apply(dev, n, W, v)
            return out, jnp.sum(v * out)

        def P(v):
            out = v * inv_diag
            return out, jnp.sum(v * out)

        lhs0 = jnp.zeros(m, dtype=rhs.dtype)
        residual0 = rhs
        sresidual0, rpn0 = P(residual0)
        Csres0, cdot0 = C(sresidual0)
        step0 = sresidual0
        Cstep0 = Csres0

        # state: (lhs, residual, sresidual, Csres, step, Cstep, cdot,
        #         resnorm_precond, iter, err, done)
        state0 = (lhs0, residual0, sresidual0, Csres0, step0, Cstep0,
                  cdot0, rpn0, jnp.int64(0), jnp.int64(_OK), jnp.bool_(False))

        def cond(state):
            return ~state[10]

        def body(state):
            (lhs, residual, sresidual, Csres, step, Cstep, cdot, rpn,
             it, err, done) = state

            resnorm = jnp.max(jnp.abs(resscale * residual))
            converged = resnorm <= tol
            hit_limit = it >= maxiter
            not_posdef = cdot <= 0.0

            precond_Cstep, pdot = P(Cstep)
            precond_bad = pdot <= 0.0
            alpha = cdot / pdot
            bad_alpha = ~jnp.isfinite(alpha)

            lhs_n = lhs + alpha * step
            residual_n = residual - alpha * Cstep
            sresidual_n = sresidual - alpha * precond_Cstep
            Csres_n, cdot_n = C(sresidual_n)
            beta = cdot_n / cdot
            step_n = sresidual_n + beta * step
            Cstep_n = Csres_n + beta * Cstep
            it_n = it + 1

            # every 5 iterations: recompute preconditioned residual and
            # require monotone decrease (lax.cond so the extra matvec only
            # runs on recheck iterations)
            do_recheck = (it_n % 5) == 0

            def recheck(args):
                residual_n, sres_n, Csres_n, cdot_n, rpn = args
                sres_re, rsdot = P(residual_n)
                Csres_re, cdot_re = C(sres_re)
                stagnated = rsdot >= rpn
                return sres_re, Csres_re, cdot_re, rsdot, stagnated

            def norecheck(args):
                residual_n, sres_n, Csres_n, cdot_n, rpn = args
                return sres_n, Csres_n, cdot_n, rpn, jnp.bool_(False)

            (sresidual_n, Csres_n, cdot_n, rpn_n, stagnated) = lax.cond(
                do_recheck, recheck, norecheck,
                (residual_n, sresidual_n, Csres_n, cdot_n, rpn))

            err_n = jnp.where(
                converged, _OK,
                jnp.where(hit_limit, _ITER_LIMIT,
                          jnp.where(not_posdef, _NOT_POSDEF,
                                    jnp.where(precond_bad,
                                              _PRECOND_NOT_POSDEF,
                                              jnp.where(bad_alpha, _INF_NAN,
                                                        jnp.where(stagnated,
                                                                  _NO_PROGRESS,
                                                                  _OK))))))
            stop = converged | hit_limit | not_posdef | precond_bad \
                | bad_alpha | stagnated

            # if stopping before the update, keep the previous state
            keep = converged | hit_limit | not_posdef | precond_bad \
                | bad_alpha
            lhs_o = jnp.where(keep, lhs, lhs_n)
            residual_o = jnp.where(keep, residual, residual_n)
            sresidual_o = jnp.where(keep, sresidual, sresidual_n)
            Csres_o = jnp.where(keep, Csres, Csres_n)
            step_o = jnp.where(keep, step, step_n)
            Cstep_o = jnp.where(keep, Cstep, Cstep_n)
            cdot_o = jnp.where(keep, cdot, cdot_n)
            rpn_o = jnp.where(keep, rpn, rpn_n)
            it_o = jnp.where(keep, it, it_n)

            return (lhs_o, residual_o, sresidual_o, Csres_o, step_o,
                    Cstep_o, cdot_o, rpn_o, it_o, err_n, stop)

        state = lax.while_loop(cond, body, state0)
        return state[0], state[8], state[9]

    return jax.jit(cr, static_argnames="n")


class DeviceNormalCR:
    """Per-factorization device CR solver used by KKTSolverDiag."""

    # Minimum problem size for the device path in auto mode. Carried over
    # from an earlier accelerator; not measured on the GPU.
    MIN_NNZ_AUTO = 20_000

    @classmethod
    def worthwhile(cls, model: Model) -> bool:
        """Auto mode: the device path for large enough models on a GPU."""
        if model.A is None or model.A.nnz < cls.MIN_NNZ_AUTO:
            return False
        return (backend.accelerator().platform
                in backend.ACCELERATOR_PLATFORMS)

    def __init__(self, model: Model, W: np.ndarray, diag: np.ndarray,
                 resscale: np.ndarray):
        jax = get_jax()
        jnp = jax.numpy
        self.jax = jax
        self.model = model
        m, n = model.num_rows, model.num_cols
        self.m = m

        # build (or reuse) the SpMV operands
        from .spmv import NormalMatrixDevice
        if not hasattr(model, "_normal_device"):
            model._normal_device = NormalMatrixDevice(model.A)
        self._fn = partial(cr_program(), n=n)
        self._dev = model._normal_device.tree
        self._W = jnp.asarray(W)
        self._diag = jnp.asarray(diag)
        self._resscale = jnp.asarray(resscale)

    def solve(self, rhs: np.ndarray, tol: float, maxiter: int
              ) -> Tuple[np.ndarray, int, int, float, float]:
        """Returns (y, iters, errflag, total_time, matvec_time_estimate)."""
        jnp = self.jax.numpy
        if maxiter < 0:
            maxiter = self.m + 100
        t0 = perf_counter()
        lhs, iters, err = self._fn(self._dev, self._W, self._diag,
                                   self._resscale, jnp.asarray(rhs),
                                   jnp.float64(tol), jnp.int64(maxiter))
        lhs = np.asarray(lhs)
        iters = int(iters)
        err = _ERRFLAG_MAP[int(err)]
        dt = perf_counter() - t0
        # attribute ~80% of loop time to the matvec (dominant cost)
        return lhs, iters, err, dt, 0.8 * dt


class MixedPrecisionDeviceCR:
    """f32 device CR with f64 iterative refinement (the mixed-precision KKT
    design of SURVEY §7.4: f32 matvecs where the work is, f64 accuracy at
    the interface).

    Each refinement step solves C dy = r with the WHOLE CR loop on device
    in float32 (half the bytes of the f64 SpMV, which is bandwidth-bound),
    then recomputes the true residual r = rhs - C y in float64 with ONE
    host matvec and restarts until the scaled infinity norm meets the f64
    tolerance. Classic defect correction: each pass gains the ~6 digits f32
    can resolve, so a handful of passes reach 1e-12.
    """

    MAX_REFINEMENTS = 30
    # one f32 pass cannot reduce the scaled residual below ~1e-6 relative
    F32_FLOOR = 1e-5

    def __init__(self, model: Model, W: np.ndarray, diag: np.ndarray,
                 resscale: np.ndarray, host_apply=None):
        jax = get_jax()
        jnp = jax.numpy
        self.jax = jax
        self.model = model
        m, n = model.num_rows, model.num_cols
        self.m, self.n = m, n

        from .spmv import NormalMatrixDevice
        if not hasattr(model, "_normal_device32"):
            model._normal_device32 = NormalMatrixDevice(
                model.A, dtype=np.float32)
        self._fn = partial(cr_program(), n=n)
        self._dev = model._normal_device32.tree
        f32 = jnp.float32
        self._W32 = jnp.asarray(W, dtype=f32)
        self._diag32 = jnp.asarray(diag, dtype=f32)
        self._resscale32 = jnp.asarray(resscale, dtype=f32)
        # f64 host-side data for the refinement residual
        self._W = np.asarray(W, dtype=np.float64)
        self._resscale = np.asarray(resscale, dtype=np.float64)
        self._host_apply = host_apply or self._default_host_apply

    def _default_host_apply(self, y: np.ndarray) -> np.ndarray:
        md = self.model
        n = self.n
        u = md.AIt_mul(y)
        return md.AI_mul(self._W * u)

    def _snorm(self, r: np.ndarray) -> float:
        return float(np.max(np.abs(self._resscale * r), initial=0.0))

    def solve(self, rhs: np.ndarray, tol: float, maxiter: int
              ) -> Tuple[np.ndarray, int, int, float, float]:
        """Returns (y, iters, errflag, total_time, matvec_time_estimate)."""
        jax = self.jax
        jnp = jax.numpy
        if maxiter < 0:
            maxiter = self.m + 100
        t0 = perf_counter()
        y = np.zeros(self.m)
        r = np.asarray(rhs, dtype=np.float64).copy()
        iters_total = 0
        err = 0
        snorm = self._snorm(r)
        best_snorm = snorm
        for _ in range(self.MAX_REFINEMENTS):
            if snorm <= tol:
                break
            if iters_total >= maxiter:
                err = int(Errflag.CR_ITER_LIMIT)
                break
            inner_tol = max(tol, self.F32_FLOOR * snorm)
            dy, it, inner_err = self._fn(
                self._dev, self._W32, self._diag32, self._resscale32,
                jnp.asarray(r, dtype=jnp.float32),
                jnp.float32(inner_tol),
                jnp.int64(maxiter - iters_total))
            iters_total += int(it)
            y = y + np.asarray(dy, dtype=np.float64)
            r = np.asarray(rhs, dtype=np.float64) - self._host_apply(y)
            new_snorm = self._snorm(r)
            if not np.isfinite(new_snorm):
                err = int(Errflag.CR_INF_OR_NAN)
                break
            if new_snorm > tol and new_snorm >= 0.9 * best_snorm:
                # refinement stalled above tolerance: no further f32 pass
                # can make progress
                err = _ERRFLAG_MAP[int(inner_err)] \
                    or int(Errflag.CR_NO_PROGRESS)
                break
            best_snorm = min(best_snorm, new_snorm)
            snorm = new_snorm
        else:
            err = int(Errflag.CR_NO_PROGRESS)
        if snorm <= tol:
            err = 0
        dt = perf_counter() - t0
        return y, iters_total, err, dt, 0.8 * dt
