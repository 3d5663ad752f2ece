"""Batched scenario IPM: solve many LPs sharing one constraint matrix.

New capability with no counterpart in the reference (see SURVEY.md §2.3):
a fleet of LPs with a COMMON sparsity pattern A but perturbed rhs b[k] and
objective c[k] (scenario sets) solved simultaneously, with the ENTIRE
phase-1 interior point method — starting point, predictor-corrector with
batched diagonal-preconditioned CR, step sizes, termination — as jitted
device code over a scenario batch axis. Per-scenario convergence masks
freeze finished scenarios while the rest continue.

The math per scenario is the reference phase-1 algorithm (reference:
src/ipm.cc, src/kkt_solver_diag.cc) restricted to the barrier/free states
(states never change before the basis phase switch). All arrays are
(dim, batch) in float64; matvecs run through take + segment_sum
(ipx_tpu.ops.spmv).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..ops.backend import accelerator, get_jax as _jx
from ..ops.spmv import NormalMatrixDevice, apply_csr, normal_apply, operand

INF = np.inf


@dataclasses.dataclass
class BatchedLp:
    """B scenario LPs min c_k'x st A x + slack = b_k, lb <= x <= ub
    (shared A and bounds, per-scenario b and c over structural part)."""
    A: sp.csc_matrix
    b: np.ndarray          # (B, m)
    c: np.ndarray          # (B, n+m)
    lb: np.ndarray         # (n+m,)
    ub: np.ndarray         # (n+m,)

    @property
    def batch(self) -> int:
        return self.b.shape[0]


class BatchedPhase1Solver:
    """Host wrapper around the jitted batched IPM iteration."""

    def __init__(self, lp: BatchedLp, feasibility_tol=1e-6,
                 optimality_tol=1e-8, kkt_tol=0.3, cr_maxiter=500,
                 maxiter=100, cr_dtype="auto", cr64_maxiter=None):
        jax = _jx()
        jnp = jax.numpy
        self.jax = jax
        self.lp = lp
        m, n = lp.A.shape
        self.m, self.n = m, n
        nm = n + m
        self.nmd = NormalMatrixDevice(lp.A)

        self.static = dict(
            lb=jnp.asarray(lp.lb), ub=jnp.asarray(lp.ub),
            finl=jnp.isfinite(jnp.asarray(lp.lb)),
            finu=jnp.isfinite(jnp.asarray(lp.ub)),
            norm_bounds=float(max(
                np.abs(lp.b).max(initial=0.0),
                np.abs(lp.lb[np.isfinite(lp.lb)]).max(initial=0.0),
                np.abs(lp.ub[np.isfinite(lp.ub)]).max(initial=0.0))),
            norm_c=float(np.abs(lp.c).max(initial=0.0)),
            feasibility_tol=feasibility_tol,
            optimality_tol=optimality_tol,
            kkt_tol=kkt_tol,
            cr_maxiter=cr_maxiter,
            # separate budget for the f64 defect-correction finish; capping
            # it bounds the worst-case step execution time
            cr64_maxiter=(cr64_maxiter if cr64_maxiter is not None
                          else cr_maxiter),
        )
        self.maxiter = maxiter
        self.bT = jnp.asarray(lp.b.T)          # (m, B)
        self.cT = jnp.asarray(lp.c.T)          # (nm, B)

        # The SpMV operands AND the per-scenario data (bT, cT, A².data) are
        # passed as jit ARGUMENTS (not closed over): closed-over device
        # arrays embed every element as program constants and invite
        # constant-folding over the data.
        A2 = lp.A.tocsr().copy()
        A2.data = A2.data ** 2
        A2.sort_indices()
        self._ops_tree = dict(self.nmd.tree, bT=self.bT, cT=self.cT,
                              A2=operand(A2.indptr, A2.indices, A2.data, m))
        # mixed precision: the inner CR loop runs in f32 (same scheme as
        # the host native CR: f32 recurrences, f64 outer Newton); the SpMV
        # is bandwidth-bound, so f32 halves its bytes. Phase-1 CR
        # tolerances (kkt_tol*sqrt(mu) with mu >= ~1e-8) sit far above the
        # f32 roundoff floor, and the predictor-corrector absorbs inexact
        # directions (inexact Newton, reference loc.cit.). "auto" picks
        # f32 when the program runs on an accelerator and f64 on the CPU
        # backend, where the f32 chunking only adds restarts.
        if cr_dtype == "auto":
            cr_dtype = "f64" if accelerator().platform == "cpu" else "f32"
        self.cr_dtype = cr_dtype
        if cr_dtype == "f32":
            jnp32 = jnp.float32
            t32 = dict(self._ops_tree["At"])
            t32["vals"] = t32["vals"].astype(jnp32)
            a32 = dict(self._ops_tree["A"])
            a32["vals"] = a32["vals"].astype(jnp32)
            self._ops_tree = dict(self._ops_tree, A32=a32, At32=t32)
        self._ops = None

        def _with_ops(ops, fn, *a):
            self._ops = ops
            bT, cT = self.bT, self.cT
            self.bT, self.cT = ops["bT"], ops["cT"]
            try:
                return fn(*a)
            finally:
                self._ops = None
                self.bT, self.cT = bT, cT

        def _start_with_ops(ops, dummy):
            return _with_ops(ops, self._starting_point, dummy)

        def _step_with_ops(ops, S):
            return _with_ops(ops, self._ipm_step, S)

        self._start_fn = jax.jit(_start_with_ops)
        # donate the state: halves live HBM at large (n+m, B) — every step
        # consumes its input state and produces the next one
        self._step_fn = jax.jit(_step_with_ops, donate_argnums=(1,))

    # ------------------------------------------------------------------
    # batched linear algebra helpers (column-major batch: arrays (dim, B))
    # ------------------------------------------------------------------
    def _AI_mul(self, X):
        n = self.n
        if self._ops is not None:
            return apply_csr(self._ops["A"], self.m, X[:n]) + X[n:]
        return self.nmd.apply_batched_struct(X[:n]) + X[n:]

    def _AIt_mul(self, Y):
        jnp = self.jax.numpy
        if self._ops is not None:
            At = apply_csr(self._ops["At"], self.n, Y)
            return jnp.concatenate([At, Y], axis=0)
        return jnp.concatenate([self.nmd.applyT_batched_struct(Y), Y], axis=0)

    def _normal_apply(self, W, V):
        if self._ops is not None:
            return normal_apply(self._ops, self.n, W, V)
        return self.nmd.apply_batched(W, V)

    def step_cr_budget(self) -> int:
        """Max CR trips one IPM step can spend (2 solves; the f32 path
        adds the f64-finish budget on top of the f32 chunks)."""
        per_solve = self.static["cr_maxiter"]
        if self.cr_dtype == "f32":
            per_solve += self.static["cr64_maxiter"]
        return 2 * per_solve

    def _normal_apply32(self, W32, V32):
        """f32 batched AI W AI' V through the f32 operand trees."""
        return normal_apply(dict(A=self._ops["A32"], At=self._ops["At32"]),
                            self.n, W32, V32)

    def _cr_loop(self, C, P, resscale, RHS, tol, maxiter):
        """One preconditioned-CR while loop with per-scenario freeze, in
        the dtype of RHS. Returns (Y, trips)."""
        jax = self.jax
        jnp = jax.numpy
        lax = jax.lax

        Y0 = jnp.zeros_like(RHS)
        R0 = RHS
        S0, _ = P(R0)
        CS0, cdot0 = C(S0)

        state0 = (Y0, R0, S0, CS0, S0, CS0, cdot0, jnp.int64(0))

        def cond(state):
            _, R, *_, it = state
            resnorm = jnp.max(jnp.abs(resscale * R), axis=0)
            return (it < maxiter) & jnp.any(resnorm > tol)

        def body(state):
            Y, R, S, CS, D, CD, cdot, it = state
            resnorm = jnp.max(jnp.abs(resscale * R), axis=0)
            active = resnorm > tol                     # (B,)

            PCD, pdot = P(CD)
            alpha = jnp.where((pdot > 0) & active, cdot / pdot, 0.0)
            Y = Y + alpha * D
            R = R - alpha * CD
            S = S - alpha * PCD
            CS, cdot_new = C(S)
            beta = jnp.where(cdot > 0, cdot_new / cdot, 0.0)
            beta = jnp.where(active, beta, 0.0)
            D = S + beta * D
            CD = CS + beta * CD
            return (Y, R, S, CS, D, CD, cdot_new, it + 1)

        state = lax.while_loop(cond, body, state0)
        return state[0], state[7]

    def _cr_solve(self, W, diag, resscale, RHS, tol):
        """Batched preconditioned CR on the normal equations: solves
        (AI W AI') Y = RHS per scenario to scaled-infnorm tol (per-scenario
        vector). With cr_dtype == 'f32' (the accelerator default) the
        recurrences run in f32 chunks wrapped in f64 defect correction — the
        same scheme as the host native mixed-precision CR (ipxlu.cc
        cr_diag_explicit_mixed): phase-1 CR tolerances sit far above the
        f32 roundoff floor for most of the run, and the f64 outer residual
        recovers the rest."""
        jax = self.jax
        jnp = jax.numpy
        lax = jax.lax
        inv_diag = 1.0 / diag

        def C(V):
            out = self._normal_apply(W, V)
            return out, jnp.sum(V * out, axis=0)

        def P(V):
            out = V * inv_diag
            return out, jnp.sum(V * out, axis=0)

        f32 = self.cr_dtype == "f32" and self._ops is not None \
            and "A32" in self._ops
        if not f32:
            return self._cr_loop(C, P, resscale, RHS, tol,
                                 self.static["cr_maxiter"])

        dt = jnp.float32
        W32, inv32 = W.astype(dt), inv_diag.astype(dt)
        rs32 = resscale.astype(dt)
        tol32 = tol.astype(dt) if hasattr(tol, "astype") else tol

        def C32(V):
            out = self._normal_apply32(W32, V)
            return out, jnp.sum(V * out, axis=0)

        def P32(V):
            out = V * inv32
            return out, jnp.sum(V * out, axis=0)

        # f64 defect correction around capped f32 CR chunks: each outer
        # pass solves C dY = R in f32 (CHUNK trips max), accumulates Y in
        # f64 and recomputes the true f64 residual. Stops on convergence,
        # iteration budget, or when an outer pass stops reducing the worst
        # scaled residual (f32 floor reached + refinement no longer
        # helping).
        CHUNK = min(125, self.static["cr_maxiter"])
        maxit = self.static["cr_maxiter"]

        def outer_cond(st):
            Y, R, trips, best, stalled = st
            resnorm = jnp.max(jnp.abs(resscale * R), axis=0)
            return (trips < maxit) & jnp.any(resnorm > tol) & ~stalled

        def outer_body(st):
            Y, R, trips, best, stalled = st
            budget = jnp.minimum(CHUNK, maxit - trips)
            dY32, t = self._cr_loop(C32, P32, rs32, R.astype(dt), tol32,
                                    budget)
            Y = Y + dY32.astype(RHS.dtype)
            CY, _ = C(Y)
            R = RHS - CY
            resnorm = jnp.max(jnp.abs(resscale * R), axis=0)
            worst = jnp.max(jnp.where(resnorm > tol, resnorm / tol, 0.0))
            stalled = worst >= 0.9 * best
            best = jnp.minimum(best, worst)
            return (Y, R, trips + t, best, stalled)

        st0 = (jnp.zeros_like(RHS), RHS, jnp.int64(0),
               jnp.asarray(jnp.inf, RHS.dtype), jnp.asarray(False))
        Y, R, trips, _, _ = lax.while_loop(outer_cond, outer_body, st0)
        # f64 finish: lanes whose scaled residual the f32 floor cannot
        # close (cond(S)*eps32 > 1 late in phase 1) get their own budget
        # of f64 CR on the defect. No-op when all lanes already converged;
        # when the budget runs out the IPM proceeds with the inexact
        # direction (inexact Newton, kkt_tol absorbs it).
        dY, t2 = self._cr_loop(C, P, resscale, R, tol,
                               self.static["cr64_maxiter"])
        return Y + dY, trips + t2

    # ------------------------------------------------------------------
    def _starting_point(self, dummy):
        """Batched version of the reference starting point procedure
        (reference: src/ipm.cc:125-259)."""
        jax = self.jax
        jnp = jax.numpy
        st = self.static
        m, n = self.m, self.n
        nm = n + m
        B = self.bT.shape[1]
        lb, ub = st["lb"][:, None], st["ub"][:, None]
        finl, finu = st["finl"][:, None], st["finu"][:, None]

        W1 = jnp.ones((nm, B))
        diag = self._diag_ones()      # diag(AI AI') for the W = I solves

        X = jnp.clip(jnp.zeros((nm, B)), lb, ub)
        RB = self.bT - self._AI_mul(X)
        tol = 0.1 * jnp.max(jnp.abs(RB), axis=0) + 1e-300
        DY, it_sp = self._cr_solve(W1, diag, jnp.ones((m, 1)), RB, tol)
        DX = self._AIt_mul(DY)             # W = I: x = AI'(y)
        X = X + DX

        XL = X - lb
        XU = ub - X
        xinfeas = jnp.maximum(jnp.max(jnp.where(finl, -XL, 0.0), axis=0),
                              jnp.max(jnp.where(finu, -XU, 0.0), axis=0))
        xshift = 1.0 + 1.5 * jnp.maximum(xinfeas, 0.0)
        XL = XL + xshift
        XU = XU + xshift

        # dual: least squares AI'y = c
        tolc = 0.1 * jnp.max(jnp.abs(self.cT), axis=0) + 1e-300
        CB = self._AI_mul(W1 * self.cT)
        Y, it_sd = self._cr_solve(W1, diag, jnp.ones((m, 1)), CB, tolc)
        Z = self.cT - self._AIt_mul(Y)

        cnorm = jnp.sqrt(jnp.sum(self.cT ** 2, axis=0))
        znorm = jnp.sqrt(jnp.sum(Z ** 2, axis=0))
        rho = 0.05
        fixup = znorm < rho * cnorm
        Z = jnp.where(fixup, Z + rho * self.cT, Z)
        Y = jnp.where(fixup, (1.0 - rho) * Y, Y)

        boxed = finl & finu
        ZL = jnp.where(boxed, 0.5 * Z, jnp.where(finl, Z, 0.0))
        ZU = jnp.where(boxed, -0.5 * Z, jnp.where(finu & ~finl, -Z, 0.0))
        zinfeas = jnp.maximum(jnp.max(jnp.where(finl, -ZL, 0.0), axis=0),
                              jnp.max(jnp.where(finu, -ZU, 0.0), axis=0))
        zshift = 1.0 + 1.5 * jnp.maximum(zinfeas, 0.0)
        ZL = jnp.where(finl, ZL + zshift, 0.0)
        ZU = jnp.where(finu, ZU + zshift, 0.0)

        xsum = 1.0 + jnp.sum(jnp.where(finl, XL, 0.0), axis=0) \
            + jnp.sum(jnp.where(finu, XU, 0.0), axis=0)
        zsum = 1.0 + jnp.sum(jnp.where(finl, ZL, 0.0), axis=0) \
            + jnp.sum(jnp.where(finu, ZU, 0.0), axis=0)
        mu = 1.0 + jnp.sum(jnp.where(finl, XL * ZL, 0.0), axis=0) \
            + jnp.sum(jnp.where(finu, XU * ZU, 0.0), axis=0)
        XL = XL + 0.5 * mu / zsum
        XU = XU + 0.5 * mu / zsum
        ZL = jnp.where(finl, ZL + 0.5 * mu / xsum, 0.0)
        ZU = jnp.where(finu, ZU + 0.5 * mu / xsum, 0.0)

        XL = jnp.where(finl, XL, INF)
        XU = jnp.where(finu, XU, INF)
        return dict(X=X, XL=XL, XU=XU, Y=Y, ZL=ZL, ZU=ZU,
                    done=jnp.zeros(self.bT.shape[1], dtype=bool),
                    iters=jnp.zeros(self.bT.shape[1], dtype=jnp.int64),
                    mu=jnp.zeros(self.bT.shape[1]),
                    cr=jnp.asarray(it_sp + it_sd, dtype=jnp.int64))

    def _diag_ones(self):
        """diag(AI AI') as a device constant (W = 1)."""
        jnp = self.jax.numpy
        A2 = self.lp.A.copy()
        A2.data = A2.data ** 2
        d = np.asarray(A2.sum(axis=1)).ravel() + 1.0
        return jnp.asarray(d)[:, None]

    # ------------------------------------------------------------------
    def _residuals(self, S):
        jnp = self.jax.numpy
        st = self.static
        lb, ub = st["lb"][:, None], st["ub"][:, None]
        finl, finu = st["finl"][:, None], st["finu"][:, None]
        RB = self.bT - self._AI_mul(S["X"])
        RC = self.cT - self._AIt_mul(S["Y"]) - S["ZL"] + S["ZU"]
        RL = jnp.where(finl, lb - S["X"] + S["XL"], 0.0)
        RU = jnp.where(finu, ub - S["X"] - S["XU"], 0.0)
        return RB, RC, RL, RU

    def _mu_of(self, S):
        jnp = self.jax.numpy
        st = self.static
        finl, finu = st["finl"][:, None], st["finu"][:, None]
        num = jnp.sum(finl) + jnp.sum(finu)
        comp = jnp.sum(jnp.where(finl, S["XL"] * S["ZL"], 0.0), axis=0) \
            + jnp.sum(jnp.where(finu, S["XU"] * S["ZU"], 0.0), axis=0)
        return comp / jnp.maximum(num, 1)

    def _ipm_step(self, S):
        """One batched Mehrotra predictor-corrector iteration."""
        jax = self.jax
        jnp = jax.numpy
        st = self.static
        m, n = self.m, self.n
        finl, finu = st["finl"][:, None], st["finu"][:, None]

        RB, RC, RL, RU = self._residuals(S)
        XL, XU, ZL, ZU = S["XL"], S["XU"], S["ZL"], S["ZU"]
        mu = self._mu_of(S)

        # convergence test (feasible && optimal)
        pres = jnp.maximum(jnp.max(jnp.abs(RB), axis=0),
                           jnp.maximum(jnp.max(jnp.abs(RL), axis=0),
                                       jnp.max(jnp.abs(RU), axis=0)))
        dres = jnp.max(jnp.abs(RC), axis=0)
        pobj = jnp.sum(self.cT * S["X"], axis=0)
        dobj = jnp.sum(self.bT * S["Y"], axis=0) \
            + jnp.sum(jnp.where(finl, st["lb"][:, None] * ZL, 0.0), axis=0) \
            - jnp.sum(jnp.where(finu, st["ub"][:, None] * ZU, 0.0), axis=0)
        gap = jnp.abs(pobj - dobj) / (1.0 + 0.5 * jnp.abs(pobj + dobj))
        feas = (pres <= st["feasibility_tol"] * (1.0 + st["norm_bounds"])) \
            & (dres <= st["feasibility_tol"] * (1.0 + st["norm_c"]))
        done = S["done"] | (feas & (gap <= st["optimality_tol"]))

        # KKT weights
        G = jnp.where(finl, ZL / XL, 0.0) + jnp.where(finu, ZU / XU, 0.0)
        regval = jnp.minimum(mu, jnp.min(jnp.where(G > 0, G, INF), axis=0))
        W = jnp.where(G > 0, 1.0 / G, 1.0 / regval)
        A2 = self._diag_w(W)
        resscale = 1.0 / jnp.sqrt(W[n:])
        tol = st["kkt_tol"] * jnp.sqrt(jnp.maximum(mu, 1e-300))

        def newton(SL, SU):
            RHS1 = -RC
            RHS1 = RHS1 + jnp.where(finl, (SL + ZL * RL) / XL, 0.0)
            RHS1 = RHS1 - jnp.where(finu, (SU - ZU * RU) / XU, 0.0)
            RHS2 = RB
            # reduce to normal equations
            rhs = self._AI_mul(W * RHS1) - RHS2
            DY, cr_iters = self._cr_solve(W, A2, resscale, rhs, tol)
            ATY = self._AIt_mul(DY)
            DX = W * (RHS1 - ATY)
            # slack part: x_slack = rhs2 - A x_struct (keeps residual in
            # the slack rows, reference: src/kkt_solver_diag.cc:107-118)
            if self._ops is not None:
                Adx = apply_csr(self._ops["A"], m, DX[:n])
            else:
                Adx = self.nmd.apply_batched_struct(DX[:n])
            DX = jnp.concatenate([DX[:n], RHS2 - Adx], axis=0)
            DYn = -DY
            DXL = jnp.where(finl | finu, DX - RL, 0.0)
            DZL = jnp.where(finl | finu, (SL - ZL * DXL) / XL, 0.0)
            DXU = jnp.where(finl | finu, RU - DX, 0.0)
            DZU = jnp.where(finl | finu, (SU - ZU * DXU) / XU, 0.0)
            ATDY = self._AIt_mul(DYn)
            lower = ZL * XU >= ZU * XL
            use_l = (finl | finu) & jnp.isfinite(XL) \
                & (~jnp.isfinite(XU) | lower)
            use_u = (finl | finu) & jnp.isfinite(XU) & ~use_l
            DZL = jnp.where(use_l, RC + DZU - ATDY, DZL)
            DZU = jnp.where(use_u, -RC + DZL + ATDY, DZU)
            DXL = jnp.where(jnp.isfinite(DXL), DXL, 0.0)
            DXU = jnp.where(jnp.isfinite(DXU), DXU, 0.0)
            DZL = jnp.where(jnp.isfinite(DZL), DZL, 0.0)
            DZU = jnp.where(jnp.isfinite(DZU), DZU, 0.0)
            return DX, DXL, DXU, DYn, DZL, DZU, cr_iters

        # predictor
        SL = jnp.where(finl, -XL * ZL, 0.0)
        SU = jnp.where(finu, -XU * ZU, 0.0)
        DX, DXL, DXU, DY, DZL, DZU, it1 = newton(SL, SU)

        maxp = jnp.minimum(_step_batch(self.jax, XL, DXL, finl),
                           _step_batch(self.jax, XU, DXU, finu))
        maxd = jnp.minimum(_step_batch(self.jax, ZL, DZL, finl),
                           _step_batch(self.jax, ZU, DZU, finu))
        num_fin = jnp.sum(finl) + jnp.sum(finu)
        muaff = (jnp.sum(jnp.where(finl, (XL + maxp * DXL)
                                   * (ZL + maxd * DZL), 0.0), axis=0)
                 + jnp.sum(jnp.where(finu, (XU + maxp * DXU)
                                     * (ZU + maxd * DZU), 0.0), axis=0)) \
            / jnp.maximum(num_fin, 1)
        sigma = (muaff / jnp.maximum(mu, 1e-300)) ** 3

        # corrector (combined direction)
        SL = jnp.where(finl, -XL * ZL + sigma * mu - DXL * DZL, 0.0)
        SU = jnp.where(finu, -XU * ZU + sigma * mu - DXU * DZU, 0.0)
        DX, DXL, DXU, DY, DZL, DZU, it2 = newton(SL, SU)

        # step sizes with boundary buffer gamma_f = 0.9
        gammaf = 0.9
        maxp = jnp.minimum(_step_batch(self.jax, XL, DXL, finl),
                           _step_batch(self.jax, XU, DXU, finu))
        maxd = jnp.minimum(_step_batch(self.jax, ZL, DZL, finl),
                           _step_batch(self.jax, ZU, DZU, finu))
        alphap = jnp.minimum(gammaf * maxp + (1 - gammaf) * 1.0, 1.0 - 1e-6)
        alphad = jnp.minimum(gammaf * maxd + (1 - gammaf) * 1.0, 1.0 - 1e-6)
        alphap = jnp.minimum(alphap, maxp * (1 - 1e-12))
        alphad = jnp.minimum(alphad, maxd * (1 - 1e-12))

        upd = ~done
        BARRIER_MIN = 1e-30
        X = jnp.where(upd, S["X"] + alphap * DX, S["X"])
        XLn = jnp.where(upd & finl,
                        jnp.maximum(XL + alphap * DXL, BARRIER_MIN), XL)
        XUn = jnp.where(upd & finu,
                        jnp.maximum(XU + alphap * DXU, BARRIER_MIN), XU)
        Y = jnp.where(upd, S["Y"] + alphad * DY, S["Y"])
        ZLn = jnp.where(upd & finl,
                        jnp.maximum(ZL + alphad * DZL, BARRIER_MIN), ZL)
        ZUn = jnp.where(upd & finu,
                        jnp.maximum(ZU + alphad * DZU, BARRIER_MIN), ZU)

        out = dict(X=X, XL=XLn, XU=XUn, Y=Y, ZL=ZLn, ZU=ZUn, done=done,
                   iters=S["iters"] + upd.astype(S["iters"].dtype))
        out["mu"] = mu                  # (B,) diagnostics, costs nothing
        if "cr" in S:
            # total batched-CR while-loop trips (each = one batched normal
            # apply over all B lanes); feeds the matvecs/s reporting
            out["cr"] = S["cr"] + it1 + it2
        return out

    def _diag_w(self, W):
        """Batched diag(AI W AI') = A.^2 @ W_struct + W_slack."""
        if self._ops is not None:
            return apply_csr(self._ops["A2"], self.m, W[:self.n]) \
                + W[self.n:]
        return apply_csr(self._ops_tree["A2"], self.m, W[:self.n]) \
            + W[self.n:]

    # ------------------------------------------------------------------
    def solve(self, handoff=None):
        """Runs the batched IPM to convergence, maxiter, or the diag-era
        handoff point. Returns a dict with per-scenario solutions and
        stats (numpy).

        handoff="auto" stops the run once the batched CR saturates its
        iteration budget two steps in a row — the point where diagonal
        preconditioning has done what it can (the batched analog of the
        reference's phase switch on the CR iteration trend, reference:
        src/lp_solver.cc:340-360, min(500, 10+m/20) budget): past it the
        Newton directions are inexact and per-step progress collapses, so
        downstream (basis-preconditioned finishes) takes over. The
        default (None) always runs to convergence/maxiter — a standalone
        phase-1 solve at tight tolerances legitimately rides the CR cap
        on its final steps, which the saturation test cannot distinguish
        from the diag-era ending; only the pipeline (which has finishes
        to hand off to) uses 'auto'."""
        jnp = self.jax.numpy
        budget = self.step_cr_budget()
        S = self._start_fn(self._ops_tree, 0)
        prev_cr = int(S["cr"])
        saturated = 0
        for _ in range(self.maxiter):
            S = self._step_fn(self._ops_tree, S)
            if bool(jnp.all(S["done"])):
                break
            if handoff == "auto":
                cr = int(S["cr"])
                saturated = saturated + 1 if cr - prev_cr >= 0.8 * budget \
                    else 0
                prev_cr = cr
                if saturated >= 2:
                    break
        out = {k: np.asarray(v) for k, v in S.items()}
        out["pobj"] = np.sum(np.asarray(self.cT) * out["X"], axis=0)
        return out


def _step_batch(jax, X, DX, fin):
    """Batched max step to boundary: per scenario min over entries."""
    jnp = jax.numpy
    damp = 1.0 - np.finfo(float).eps
    cand = jnp.where(fin & (DX < 0.0) & jnp.isfinite(X),
                     -(X * damp) / DX, INF)
    return jnp.minimum(jnp.min(cand, axis=0), 1.0)


class BatchedScenarioSolver:
    """Full batched scenario solve to vertex solutions: the data-parallel
    phase-1 IPM runs over all scenarios at once (device-batched), then each
    scenario is finished by a warm-started full solve (basis-preconditioned
    phase 2 + crossover) on host. The warm start skips the initial IPM
    entirely (reference facility: src/lp_solver.cc:337-347, src/ipm.cc:
    261-316); the batching itself has no reference counterpart (SURVEY §2.3
    data-parallel analog).

    data: user-form dict as accepted by testgen.load_into_solver
    (num_var, num_constr, Ap, Ai, Ax, constr_type, lb, ub, plus default
    obj/rhs); b_batch (B, m) per-scenario rhs; obj_batch (B, n) optional
    per-scenario objectives (default: shared data["obj"]).
    """

    def __init__(self, data, b_batch, obj_batch=None, parameters=None,
                 phase1_tol=1e-4, phase1_maxiter=100,
                 phase2_polish="auto"):
        self.data = data
        # After batched phase 1, optionally polish all scenarios with
        # shared-basis preconditioned KKT solves (parallel/batch2.py)
        # before the per-scenario finishes. Costs one mean-scenario solve
        # and hands the finishes near-complementary starting points.
        # "auto" is OFF (round-5 measurement, tools/batched_finish_bench.py
        # + docs/PERFORMANCE.md): the shared-basis polish CR runs ~500
        # iterations per solve once the scenario weights diverge — one
        # polish step costs as much per scenario as a COMPLETE warm
        # basis-preconditioned finish (whose own CR takes ~3.5 iters/solve
        # thanks to per-lane drops + maxvolume). The polish remains opt-in
        # for narrow batches near the mean scenario.
        if phase2_polish == "auto":
            phase2_polish = False
        self.phase2_polish = bool(phase2_polish)
        m, n = data["num_constr"], data["num_var"]
        self.m, self.n = m, n
        b_batch = np.asarray(b_batch, dtype=float)
        assert b_batch.shape[1] == m
        B = b_batch.shape[0]
        if obj_batch is None:
            obj_batch = np.repeat(np.asarray(data["obj"], dtype=float)
                                  [None, :], B, axis=0)
        obj_batch = np.asarray(obj_batch, dtype=float)
        self.b_batch = b_batch
        self.obj_batch = obj_batch
        self.parameters = parameters
        self.phase1_tol = phase1_tol
        self.phase1_maxiter = phase1_maxiter

        A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]),
                          shape=(m, n))
        ct = np.asarray(list(data["constr_type"]))
        self._ct = ct
        # slack bounds encode the constraint type, exactly as the presolver
        # does (reference: src/presolver.cc:164-179)
        lb = np.concatenate([np.asarray(data["lb"], dtype=float),
                             np.where(ct == ">", -INF, 0.0)])
        ub = np.concatenate([np.asarray(data["ub"], dtype=float),
                             np.where(ct == "<", INF, 0.0)])
        c = np.zeros((B, n + m))
        c[:, :n] = obj_batch
        self.blp = BatchedLp(A=A, b=b_batch, c=c, lb=lb, ub=ub)

    def solve(self):
        """Returns a list of per-scenario (status, info, solver)."""
        ph1 = BatchedPhase1Solver(self.blp,
                                  feasibility_tol=self.phase1_tol,
                                  optimality_tol=self.phase1_tol,
                                  maxiter=self.phase1_maxiter)
        out = ph1.solve(handoff="auto")    # finishes absorb the tail
        if self.phase2_polish:
            out = self._polish(out)
        return self._finish(out)

    def _finish(self, out):
        """Per-scenario warm-started finishes (phase 2 + crossover) from a
        batched state dict."""
        from ..lp_solver import LpSolver
        from ..parameters import Parameters
        from ..status import SolveStatus

        m, n = self.m, self.n
        d = self.data
        ct = self._ct
        mean_basis = getattr(self, "_mean_basis", None)
        if mean_basis is None:
            mean_basis = self._solve_mean_basis()
        results = []
        for k in range(self.blp.batch):
            import dataclasses as _dc
            p = (_dc.replace(self.parameters) if self.parameters is not None
                 else Parameters())
            if self.parameters is None:
                p.display = 0      # quiet per-scenario finishes by default
            p.dualize = 0          # warm start is refused on dualized models
            s = LpSolver(p)
            rc = s.load_model(n, self.obj_batch[k], d["lb"], d["ub"], m,
                              d["Ap"], d["Ai"], d["Ax"], self.b_batch[k],
                              d["constr_type"])
            assert rc == 0
            x = out["X"][:n, k]
            slack = out["X"][n:, k].copy()
            # equality slacks must be exactly zero; dual signs projected
            # (warm-start repair restores strict complementarity)
            slack[ct == "="] = 0.0
            slack[ct == "<"] = np.maximum(slack[ct == "<"], 0.0)
            slack[ct == ">"] = np.minimum(slack[ct == ">"], 0.0)
            y = out["Y"][:, k].copy()
            y[ct == "<"] = np.minimum(y[ct == "<"], 0.0)
            y[ct == ">"] = np.maximum(y[ct == ">"], 0.0)
            rc = s.load_ipm_starting_point(
                x, out["XL"][:n, k], out["XU"][:n, k], slack, y,
                out["ZL"][:n, k], out["ZU"][:n, k])
            if rc != 0:
                # fall back to a cold solve if the point is rejected
                s.clear_solution()
            if mean_basis is not None:
                s.load_starting_basis(mean_basis)
            status = s.solve()
            # Safety net: a rough batched state (loose phase-1 tolerance)
            # can steer the warm-started IPM into a false infeasibility,
            # no-progress or iteration-limit verdict. The warm start is
            # only an accelerator here — re-solve cold before accepting a
            # non-optimal outcome.
            bad = (int(SolveStatus.PRIMAL_INFEAS),
                   int(SolveStatus.DUAL_INFEAS),
                   int(SolveStatus.NO_PROGRESS), int(SolveStatus.FAILED),
                   int(SolveStatus.ITER_LIMIT))
            if s.get_info().status_ipm in bad:
                s2 = LpSolver(p)
                rc2 = s2.load_model(n, self.obj_batch[k], d["lb"], d["ub"],
                                    m, d["Ap"], d["Ai"], d["Ax"],
                                    self.b_batch[k], d["constr_type"])
                assert rc2 == 0
                status2 = s2.solve()
                if s2.get_info().status_ipm not in bad \
                        or status2 == 1000:
                    status, s = status2, s2
            results.append((status, s.get_info(), s))
        return results

    def _solve_mean_basis(self):
        """Solves the mean scenario once (crossover off) and returns its
        basis array for sharing across finishes, or None on any failure.
        Amortized over the batch this replaces B crash constructions by one
        solve + B factorizations of a known-good basis."""
        try:
            import dataclasses as _dc
            from ..lp_solver import LpSolver
            from ..parameters import Parameters
            p = (_dc.replace(self.parameters) if self.parameters is not None
                 else Parameters())
            p.dualize = 0
            p.crossover = 0
            p.display = 0
            s = LpSolver(p)
            d = self.data
            rc = s.load_model(self.n, np.mean(self.obj_batch, axis=0),
                              d["lb"], d["ub"], self.m, d["Ap"], d["Ai"],
                              d["Ax"], np.mean(self.b_batch, axis=0),
                              d["constr_type"])
            if rc != 0 or s.solve() != 1000 or s.basis is None:
                return None
            self._mean_basis = np.asarray(s.basis.basis,
                                          dtype=np.int64).copy()
            return self._mean_basis
        except Exception:
            return None

    def _polish(self, out):
        """Shared-basis batched phase-2 polish between phase 1 and the
        per-scenario finishes (parallel/batch2.py); falls back to the
        unpolished state on any failure (e.g. native kernel unavailable,
        mean scenario not solvable with the basis kept)."""
        try:
            import dataclasses as _dc
            from ..lp_solver import LpSolver
            from ..parameters import Parameters
            from .batch2 import SharedBasisBatchedPolish
            p = (_dc.replace(self.parameters) if self.parameters is not None
                 else Parameters())
            p.dualize = 0
            p.scale = 0           # model must match blp's AI exactly
            p.crossover = 0       # keep the IPM basis
            p.display = 0         # internal helper solve
            s = LpSolver(p)
            d = self.data
            rc = s.load_model(self.n, np.mean(self.obj_batch, axis=0),
                              d["lb"], d["ub"], self.m, d["Ap"], d["Ai"],
                              d["Ax"], np.mean(self.b_batch, axis=0),
                              d["constr_type"])
            if rc != 0 or s.solve() != 1000 or s.basis is None:
                return out
            basis = s.basis
            if not basis.factorization_is_fresh and basis.factorize() != 0:
                return out
            # share the mean-scenario basis with the per-scenario finishes
            # (amortizes starting-basis construction across the batch)
            self._mean_basis = np.asarray(basis.basis, dtype=np.int64).copy()
            # bounded effort: the stagnation exit usually fires first; the
            # finishes mop up whatever the shared basis cannot polish
            polish = SharedBasisBatchedPolish(self.blp, basis, maxiter=40)
            state = {k: out[k] for k in ("X", "XL", "XU", "Y", "ZL", "ZU",
                                         "done", "iters")}
            polished = polish.run(state)
            polished["pobj"] = np.sum(
                np.asarray(polish._ph1.cT) * polished["X"], axis=0)
            return polished
        except Exception:
            return out
