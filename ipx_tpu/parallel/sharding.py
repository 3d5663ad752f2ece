"""Multi-chip sharding: row-block partitioned KKT apply over a device mesh.

Scale-out of the phase-1 KKT solve (no counterpart in the single-process
reference, see SURVEY.md §2.3/§5.8): the constraint matrix AI is
partitioned into row blocks across a mesh axis ("rows"); each device holds
its block's CSR/CSC arrays (padded to a common static capacity) plus the
full structural column space. One normal-matrix apply is then

    u_p    = A_p' v_p                (local take + segment_sum)
    u      = psum(u_p, "rows")       (all-reduce over row blocks)
    out_p  = A_p (W u) + W_slack_p v_p   (local)

with CR inner products as psum-reduced partials. Expressed with
jax.shard_map over a jax.sharding.Mesh — XLA inserts the collectives. The
cards of one host are connected all to all, so the mesh follows the
algorithm alone.

A second mesh axis ("batch") shards scenario batches (data parallel); the
two compose: V is (m_p, B_local) per device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..ops.backend import get_jax as _jx
from ..ops.spmv import apply_csr, segment_ids

INF = np.inf


class ShardedNormalMatrix:
    """Row-block partitioned AI W AI' apply.

    Host-side: builds per-block operand arrays stacked on a leading axis of
    size num_blocks, each padded to identical static shapes so one jitted
    program serves every block.
    """

    def __init__(self, A: sp.csc_matrix, num_blocks: int):
        jax = _jx()
        jnp = jax.numpy
        m, n = A.shape
        self.m, self.n = m, n
        self.num_blocks = num_blocks
        self.m_block = -(-m // num_blocks)           # rows per block (padded)
        mp = self.m_block

        A_csr = A.tocsr()
        A_csr.sort_indices()

        blocks_csr = []
        blocks_csc = []
        for p in range(num_blocks):
            r0, r1 = p * mp, min((p + 1) * mp, m)
            Ab = A_csr[r0:r1]
            blocks_csr.append(Ab)
            blocks_csc.append(Ab.tocsc())
        cap = max(1, max(Ab.nnz for Ab in blocks_csr))

        def pack(mats, nseg):
            """Stacked operands of ops.spmv, padded to `cap` nonzeros;
            padding carries segment id nseg, which segment_sum drops."""
            P = len(mats)
            idx = np.zeros((P, cap), dtype=np.int32)
            val = np.zeros((P, cap), dtype=np.float64)
            seg = np.zeros((P, cap), dtype=np.int32)
            for p, M in enumerate(mats):
                idx[p, :M.nnz] = M.indices
                val[p, :M.nnz] = M.data
                seg[p] = segment_ids(M.indptr, cap, nseg)
            return idx, val, seg

        # CSR operands (A_p u): segments = local rows (mp), indices = columns
        csr_idx, csr_val, csr_seg = pack(blocks_csr, mp)
        # CSC operands (A_p' v): segments = columns (n), indices = local rows
        csc_idx, csc_val, csc_seg = pack(blocks_csc, n)
        self.arrays = dict(
            csr_idx=jnp.asarray(csr_idx), csr_val=jnp.asarray(csr_val),
            csr_seg=jnp.asarray(csr_seg),
            csc_idx=jnp.asarray(csc_idx), csc_val=jnp.asarray(csc_val),
            csc_seg=jnp.asarray(csc_seg),
        )

    @staticmethod
    def _block(blk, kind):
        """This device's operand of one direction ("csr" or "csc"); the
        per-device block keeps a leading singleton axis."""
        return dict(idx=blk[kind + "_idx"].reshape(-1),
                    vals=blk[kind + "_val"].reshape(-1),
                    seg=blk[kind + "_seg"].reshape(-1))

    def block_normal_apply(self, blk, W, V_p, axis_name: str):
        """Per-device normal apply under shard_map, for V_p of shape
        (m_block,) or (m_block, B_local). W = (W_struct, W_slack_p): the
        structural weights replicated, the slack weights row-sharded, each
        of V_p's rank. psum over the row axis assembles A' V."""
        jax = _jx()
        W_struct, W_slack_p = W
        u_part = apply_csr(self._block(blk, "csc"), self.n, V_p)
        u = jax.lax.psum(u_part, axis_name) * W_struct
        out_p = apply_csr(self._block(blk, "csr"), self.m_block, u)
        return out_p + W_slack_p * V_p


def make_row_mesh(num_blocks: int):
    """1D mesh over the first num_blocks devices of the default backend
    (axis "rows"); raises DeviceError when it has fewer."""
    from ..ops.backend import DeviceError
    jax = _jx()
    devs = jax.devices()
    if len(devs) < num_blocks:
        raise DeviceError(
            f"shards={num_blocks} needs {num_blocks} devices, but the "
            f"{jax.default_backend()} backend has {len(devs)}")
    from jax.sharding import Mesh
    return Mesh(np.array(devs[:num_blocks]), ("rows",))


class ShardedDiagCR:
    """Phase-1 KKT CR with AI row-sharded over a device mesh, reachable from
    LpSolver via Parameters.shards (SURVEY §2.3/§5.8: the model-parallel
    axis). The jitted program is built once per model; weights, diagonal,
    residual scaling, rhs, tolerance and iteration limit are runtime
    operands, so per-IPM-iteration factorizes do not recompile.

    Termination matches the KKT-solver contract: scaled inf-norm
    ||resscale . r||_inf <= tol (reference: src/kkt_solver.h:11-27)."""

    def __init__(self, A: sp.csc_matrix, num_blocks: int, mesh=None):
        self.snm = ShardedNormalMatrix(A, num_blocks)
        self.mesh = mesh if mesh is not None else make_row_mesh(num_blocks)
        self._fn = None

    def _build(self):
        jax = _jx()
        jnp = jax.numpy
        from jax.sharding import PartitionSpec as P
        shard_map = jax.shard_map
        snm = self.snm
        axis_name = "rows"

        def cr_local(blk, W_struct, W_slack_p, diag_p, resscale_p, rhs_p,
                     tol, maxiter):
            inv_diag = 1.0 / diag_p

            def C(v):
                out = snm.block_normal_apply(blk, (W_struct, W_slack_p), v,
                                             axis_name)
                return out, jax.lax.psum(jnp.sum(v * out), axis_name)

            def P_(v):
                out = v * inv_diag
                return out, jax.lax.psum(jnp.sum(v * out), axis_name)

            def resnorm_of(r):
                return jax.lax.pmax(jnp.max(jnp.abs(resscale_p * r)),
                                    axis_name)

            y0 = jnp.zeros_like(rhs_p)
            r0 = rhs_p
            s0, _ = P_(r0)
            cs0, cdot0 = C(s0)
            # err mirrors the native CR breakdown ladder (202 matrix not
            # posdef, 203 precond not posdef, 205 inf/nan); a nonzero err
            # exits the loop with the iterate frozen
            state0 = (y0, r0, s0, cs0, s0, cs0, cdot0, jnp.int64(0),
                      jnp.int64(0))

            def cond(state):
                _, r, *_, it, err = state
                return (resnorm_of(r) > tol) & (it < maxiter) & (err == 0)

            def body(state):
                y, r, s, cs, d, cd, cdot, it, err = state
                pcd, pdot = P_(cd)
                err = jnp.where(cdot <= 0.0, jnp.int64(202), err)
                err = jnp.where(pdot <= 0.0, jnp.int64(203), err)
                alpha = cdot / pdot
                err = jnp.where(~jnp.isfinite(alpha), jnp.int64(205), err)
                ok = err == 0
                alpha = jnp.where(ok, alpha, 0.0)
                y = y + alpha * d
                r = r - alpha * cd
                s = s - alpha * pcd
                cs, cdot_new = C(s)
                err = jnp.where(ok & ~jnp.isfinite(cdot_new),
                                jnp.int64(205), err)
                beta = jnp.where(ok, cdot_new / cdot, 0.0)
                d = s + beta * d
                cd = cs + beta * cd
                return (y, r, s, cs, d, cd, cdot_new, it + 1, err)

            state = jax.lax.while_loop(cond, body, state0)
            return state[0], state[7], resnorm_of(state[1]), state[8]

        spec_blk = {k: P("rows") for k in snm.arrays}
        fn = shard_map(
            cr_local, mesh=self.mesh,
            in_specs=(spec_blk, P(), P("rows"), P("rows"), P("rows"),
                      P("rows"), P(), P()),
            out_specs=(P("rows"), P(), P(), P()),
            check_vma=False)
        self._fn = jax.jit(fn)

    def solve(self, W_struct, W_slack, diag, resscale, rhs, tol: float,
              maxiter: int):
        """Returns (y (m,), iters, errflag) with errflag 201 on iteration
        limit, 0 otherwise."""
        jax = _jx()
        jnp = jax.numpy
        snm = self.snm
        if self._fn is None:
            self._build()
        m_pad = snm.num_blocks * snm.m_block
        if maxiter < 0:
            maxiter = snm.m + 100

        def pad_m(x, fill=0.0):
            out = np.full(m_pad, fill)
            out[:snm.m] = x
            return jnp.asarray(out)

        rhs_p = pad_m(rhs)
        W_slack_p = pad_m(W_slack)
        diag_p = pad_m(diag, fill=1.0)      # padding rows stay SPD
        resscale_p = pad_m(resscale)        # padded rows never terminate
        y, iters, resnorm, err = self._fn(
            snm.arrays, jnp.asarray(W_struct), W_slack_p, diag_p,
            resscale_p, rhs_p, jnp.float64(tol), jnp.int64(maxiter))
        y = np.asarray(y)[:snm.m]
        iters = int(np.asarray(iters).ravel()[0])
        err = int(np.asarray(err).ravel()[0])
        resnorm = float(np.asarray(resnorm).ravel()[0])
        # success only on a finite residual within tolerance; a NaN residual
        # must never read as converged (errflag policy per ADVICE r3)
        if err == 0 and not (np.isfinite(resnorm) and resnorm <= tol):
            err = 205 if not np.isfinite(resnorm) else 201
        return y, iters, err


def sharded_cr_solve(snm: ShardedNormalMatrix, W_struct, W_slack,
                     diag, rhs, tol: float, maxiter: int, mesh,
                     axis_name: str = "rows"):
    """Diagonal-preconditioned CR on the normal equations with the matrix
    row-sharded over `axis_name`. All m-vectors are sharded; scalars are
    psum-reduced. Returns (y, iters) with y unsharded on host."""
    jax = _jx()
    jnp = jax.numpy
    from jax.sharding import NamedSharding, PartitionSpec as P
    shard_map = jax.shard_map

    nb = snm.num_blocks
    mp = snm.m_block
    m_pad = nb * mp

    def pad_m(x):
        out = np.zeros(m_pad)
        out[:snm.m] = x
        return out

    rhs_p = jnp.asarray(pad_m(rhs))
    W_slack_p = jnp.asarray(pad_m(W_slack))
    # padding rows must keep the operator SPD: give them unit diagonal
    diag_np = pad_m(diag)
    diag_np[snm.m:] = 1.0
    diag_p = jnp.asarray(diag_np)
    W_struct = jnp.asarray(W_struct)

    def cr_local(blk, W_struct, W_slack_p, diag_p, rhs_p):
        inv_diag = 1.0 / diag_p

        def C(v):
            out = snm.block_normal_apply(blk, (W_struct, W_slack_p), v,
                                         axis_name)
            return out, jax.lax.psum(jnp.sum(v * out), axis_name)

        def P_(v):
            out = v * inv_diag
            return out, jax.lax.psum(jnp.sum(v * out), axis_name)

        y0 = jnp.zeros_like(rhs_p)
        r0 = rhs_p
        s0, _ = P_(r0)
        cs0, cdot0 = C(s0)
        state0 = (y0, r0, s0, cs0, s0, cs0, cdot0, jnp.int64(0))

        def cond(state):
            _, r, *_, it = state
            resnorm = jax.lax.pmax(jnp.max(jnp.abs(r)), axis_name)
            return (resnorm > tol) & (it < maxiter)

        def body(state):
            y, r, s, cs, d, cd, cdot, it = state
            pcd, pdot = P_(cd)
            alpha = cdot / pdot
            y = y + alpha * d
            r = r - alpha * cd
            s = s - alpha * pcd
            cs, cdot_new = C(s)
            beta = cdot_new / cdot
            d = s + beta * d
            cd = cs + beta * cd
            return (y, r, s, cs, d, cd, cdot_new, it + 1)

        state = jax.lax.while_loop(cond, body, state0)
        return state[0], state[7]

    spec_blk = {k: P("rows") for k in snm.arrays}
    fn = shard_map(
        cr_local, mesh=mesh,
        in_specs=(spec_blk, P(), P("rows"), P("rows"), P("rows")),
        out_specs=(P("rows"), P()),
        check_vma=False)
    y, iters = jax.jit(fn)(snm.arrays, W_struct, W_slack_p, diag_p, rhs_p)
    return np.asarray(y)[:snm.m], int(np.asarray(iters).ravel()[0])


def sharded_batched_cr_solve(snm: ShardedNormalMatrix, W_struct, W_slack,
                             diag, RHS, tol: float, maxiter: int, mesh,
                             row_axis: str = "rows",
                             batch_axis: str = "batch"):
    """Scenario-batched, row-sharded CR over a 2D mesh (the composition of
    the data-parallel and model-parallel axes, SURVEY §2.3): each device
    holds one row block x one scenario shard. Per-scenario weights:
    W_struct (n, B), W_slack/diag/RHS (m, B). Converged scenarios freeze
    (masked updates) while the rest keep iterating. Returns (Y (m, B),
    iters)."""
    jax = _jx()
    jnp = jax.numpy
    from jax.sharding import PartitionSpec as P
    shard_map = jax.shard_map

    nb = snm.num_blocks
    mp = snm.m_block
    m_pad = nb * mp
    B = RHS.shape[1]

    def pad_m(X):
        out = np.zeros((m_pad, B))
        out[:snm.m] = X
        return out

    RHS_p = jnp.asarray(pad_m(RHS))
    W_slack_p = jnp.asarray(pad_m(W_slack))
    diag_np = pad_m(diag)
    diag_np[snm.m:] = 1.0          # padding rows keep the operator SPD
    diag_p = jnp.asarray(diag_np)
    W_struct = jnp.asarray(W_struct)

    def cr_local(blk, W_struct, W_slack_p, diag_p, RHS_p):
        inv_diag = 1.0 / diag_p

        def C(V):
            out = snm.block_normal_apply(
                blk, (W_struct, W_slack_p), V, row_axis)
            dots = jax.lax.psum(jnp.sum(V * out, axis=0), row_axis)
            return out, dots            # dots: (B_local,)

        def P_(V):
            out = V * inv_diag
            dots = jax.lax.psum(jnp.sum(V * out, axis=0), row_axis)
            return out, dots

        Y0 = jnp.zeros_like(RHS_p)
        R0 = RHS_p
        S0, _ = P_(R0)
        CS0, cdot0 = C(S0)
        done0 = jnp.zeros(RHS_p.shape[1], dtype=bool)
        state0 = (Y0, R0, S0, CS0, S0, CS0, cdot0, done0, jnp.int64(0))

        def resnorms(R):
            return jax.lax.pmax(jnp.max(jnp.abs(R), axis=0), row_axis)

        def cond(state):
            *_, done, it = state
            return (~jnp.all(done)) & (it < maxiter)

        def body(state):
            Y, R, S, CS, D, CD, cdot, done, it = state
            done = done | (resnorms(R) <= tol)
            PCD, pdot = P_(CD)
            alpha = jnp.where(done, 0.0, cdot / jnp.where(pdot == 0.0,
                                                          1.0, pdot))
            Y = Y + alpha[None, :] * D
            R = R - alpha[None, :] * CD
            S = S - alpha[None, :] * PCD
            CS, cdot_new = C(S)
            beta = jnp.where(done, 0.0,
                             cdot_new / jnp.where(cdot == 0.0, 1.0, cdot))
            D = jnp.where(done[None, :], D, S + beta[None, :] * D)
            CD = jnp.where(done[None, :], CD, CS + beta[None, :] * CD)
            cdot = jnp.where(done, cdot, cdot_new)
            return (Y, R, S, CS, D, CD, cdot, done, it + 1)

        state = jax.lax.while_loop(cond, body, state0)
        return state[0], state[8]

    spec_blk = {k: P(row_axis) for k in snm.arrays}
    fn = shard_map(
        cr_local, mesh=mesh,
        in_specs=(spec_blk, P(None, batch_axis),
                  P(row_axis, batch_axis), P(row_axis, batch_axis),
                  P(row_axis, batch_axis)),
        out_specs=(P(row_axis, batch_axis), P()),
        check_vma=False)
    Y, iters = jax.jit(fn)(snm.arrays, W_struct, W_slack_p, diag_p, RHS_p)
    return np.asarray(Y)[:snm.m], int(np.asarray(iters).ravel()[0])


class ShardedSplittedNNt:
    """Column-sharded N N' apply for the PHASE-2 splitted operator
    (counterpart of the NNt pass in reference: src/splitted_normal_matrix.cc
    :90-117, re-architected for a device mesh): each device holds a block of
    the scaled nonbasic columns N_p and computes N_p (N_p' w); a psum over
    the mesh axis assembles the full product. The B / B' triangular solves
    stay on host (sequential by nature), so the phase-2 CR becomes
    host-solve -> device sharded NNt -> host-solve per iteration.

    Static shapes: the nonbasic count is exactly n every epoch, so the
    per-block arrays are padded to fixed capacities at construction and ONE
    jitted program serves every factorize epoch (operands are runtime
    arguments).
    """

    def __init__(self, m: int, n: int, nnz_cap: int, num_blocks: int,
                 mesh=None):
        jax = _jx()
        self.m = m
        self.n = n
        self.num_blocks = num_blocks
        self.cols_block = -(-n // num_blocks) if n else 1
        # worst-case block nnz with contiguous equal-count column blocks is
        # bounded by the total; 2x average + slack absorbs imbalance
        self.cap = 2 * (-(-nnz_cap // num_blocks)) + 128
        self.mesh = mesh if mesh is not None else make_row_mesh(num_blocks)
        self._fn = None
        self.applies = 0          # mesh-path applies (dryrun evidence)

    def set_operand(self, N) -> None:
        """Packs a fresh epoch's N (m x n csc); raises DeviceError when a
        block overflows the static capacity."""
        from ..ops.backend import DeviceError
        jax = _jx()
        jnp = jax.numpy
        nb, cb, cap = self.num_blocks, self.cols_block, self.cap
        N = N.tocsc()
        if N.shape[1] > nb * cb:
            raise DeviceError(f"N has {N.shape[1]} columns, more than the "
                              f"{nb * cb} the mesh blocks hold")
        vals = np.zeros((nb, cap))
        rows = np.zeros((nb, cap), dtype=np.int32)
        cols = np.zeros((nb, cap), dtype=np.int32)   # local column ids
        for p in range(nb):
            c0, c1 = p * cb, min((p + 1) * cb, N.shape[1])
            if c0 >= N.shape[1]:
                continue
            lo, hi = N.indptr[c0], N.indptr[c1]
            nz = hi - lo
            if nz > cap:
                raise DeviceError(f"block {p} of N holds {nz} nonzeros, "
                                  f"more than its capacity {cap}")
            vals[p, :nz] = N.data[lo:hi]
            rows[p, :nz] = N.indices[lo:hi]
            ptr = N.indptr[c0:c1 + 1] - lo
            cols[p, :nz] = np.repeat(
                np.arange(c1 - c0, dtype=np.int32), np.diff(ptr))
            # padding: col id cb (dropped by segment_sum), row id m (ditto)
            cols[p, nz:] = cb
            rows[p, nz:] = self.m
        self._vals = jnp.asarray(vals)
        self._rows = jnp.asarray(rows)
        self._cols = jnp.asarray(cols)

    def _build(self):
        jax = _jx()
        jnp = jax.numpy
        from jax.sharding import PartitionSpec as P
        m, cb = self.m, self.cols_block

        def nnt_local(vals, rows, cols, w):
            vals = vals.reshape(-1)
            rows = rows.reshape(-1)
            cols = cols.reshape(-1)
            g = jnp.take(w, rows, axis=0, mode="fill", fill_value=0.0)
            u = jax.ops.segment_sum(vals * g, cols, num_segments=cb + 1,
                                    indices_are_sorted=True)
            h = jnp.take(u, cols, axis=0)
            out = jax.ops.segment_sum(vals * h, rows, num_segments=m + 1)
            return jax.lax.psum(out[:m], "rows")

        fn = jax.shard_map(
            nnt_local, mesh=self.mesh,
            in_specs=(P("rows"), P("rows"), P("rows"), P()),
            out_specs=P(), check_vma=False)
        self._fn = jax.jit(fn)

    def apply(self, w: np.ndarray) -> np.ndarray:
        if self._fn is None:
            self._build()
        self.applies += 1
        out = self._fn(self._vals, self._rows, self._cols,
                       np.ascontiguousarray(w, dtype=np.float64))
        return np.asarray(out)


class ShardedPhase2CR:
    """Phase-2 CR with the NNt product sharded over the mesh and the B/B'
    solves on host. Same contract as the native phase-2 engine
    (inf-norm termination, breakdown codes 201/202/205); slot space with
    BASIC_FREE zeroed."""

    def __init__(self, nnt: ShardedSplittedNNt):
        self.nnt = nnt
        self.time_B = 0.0
        self.time_Bt = 0.0
        self.time_NNt = 0.0

    def _apply(self, splitted, v):
        from time import perf_counter
        s = splitted.uscale
        t0 = perf_counter()
        w = splitted._basis.solve_dense(v / s, "T")
        self.time_Bt += perf_counter() - t0
        t0 = perf_counter()
        nn = self.nnt.apply(w)
        self.time_NNt += perf_counter() - t0
        t0 = perf_counter()
        lhs = splitted._basis.solve_dense(nn, "N") / s
        self.time_B += perf_counter() - t0
        lhs = lhs + v
        if splitted.free_positions.size:
            lhs[splitted.free_positions] = 0.0
        return lhs

    def solve(self, splitted, rhs: np.ndarray, tol: float, maxiter: int):
        """Returns (lhs, iters, errflag)."""
        m = rhs.size
        if maxiter < 0:
            maxiter = m + 100
        lhs = np.zeros(m)
        r = rhs.copy()
        Cr = self._apply(splitted, r)
        cdot = float(r @ Cr)
        step = r.copy()
        Cstep = Cr.copy()
        denom = float(Cr @ Cr)
        it = 0
        err = 0
        while True:
            resnorm = float(np.max(np.abs(r))) if m else 0.0
            if np.isfinite(resnorm) and resnorm <= tol:
                break
            if it >= maxiter:
                err = 201
                break
            if not np.isfinite(resnorm):
                err = 205
                break
            if cdot <= 0.0:
                err = 202
                break
            alpha = cdot / denom
            if not np.isfinite(alpha):
                err = 205
                break
            lhs += alpha * step
            r -= alpha * Cstep
            Cr = self._apply(splitted, r)
            cdot_new = float(r @ Cr)
            beta = cdot_new / cdot
            step = r + beta * step
            Cstep = Cr + beta * Cstep
            denom = float(Cstep @ Cstep)
            cdot = cdot_new
            it += 1
        return lhs, it, err
