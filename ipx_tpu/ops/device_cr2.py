"""Phase-2 (basis-preconditioned) CR with the N~ N~' product on device.

The splitted-normal operator C = I + inv(B~) N~ N~' inv(B~') (reference:
src/splitted_normal_matrix.cc:90-117) is split between host and device:

  * the N~ N~' product runs as ONE jitted device program per CR iteration
    (take + segment_sum, ops/spmv.py);
  * the CR recurrences and the B / B' triangular solves (sequential, with
    data-dependent sparsity) run on host, exchanging one m-vector with the
    device per iteration.

Shapes are padded to fixed capacities (nnz(N) <= nnz(A) + m; N always has
exactly n columns) so ONE compiled program serves every per-IPM-iteration
factorize; only the packed operand values change.
"""
from __future__ import annotations

from time import perf_counter
from typing import Optional

import numpy as np

from .backend import get_jax
from .spmv import apply_csr, segment_ids


class _CapSegOperand:
    """take+segment_sum operand with a fixed capacity: index/value arrays
    padded with zeros and segment ids padded with num_segments (dropped by
    the segment reduction)."""

    def __init__(self, cap_nnz: int, num_segments: int):
        self.cap = cap_nnz
        self.num_segments = num_segments

    def pack(self, indptr, indices, data):
        """CSR-style pack into the operand pytree of ops.spmv (numpy)."""
        nnz = len(data)
        idx = np.zeros(self.cap, dtype=np.int32)
        idx[:nnz] = indices
        vals = np.zeros(self.cap, dtype=np.float64)
        vals[:nnz] = data
        return dict(idx=idx, vals=vals,
                    seg=segment_ids(indptr, self.cap, self.num_segments))


class DeviceSplittedCR:
    """Host-looped phase-2 CR with the NN' product jitted on device.

    One instance per KKT solver; prepare() is called per factorize with the
    current SplittedNormalMatrix (its N, uscale, free positions). solve()
    runs the CR loop on host with one device NN' apply per iteration.
    `applies` counts the device NN' products.
    """

    def __init__(self, model):
        jax = get_jax()
        self.jax = jax
        md = model
        self.m = md.num_rows
        self.n = md.num_cols
        m, n = self.m, self.n
        cap_nnz = int(md.A.nnz) + m
        self._opN = _CapSegOperand(cap_nnz, m)     # N u   (segments = rows)
        self._opNt = _CapSegOperand(cap_nnz, n)    # N' w  (segments = cols)
        self._basis = None                         # repointed by prepare()
        self._fn = None
        self.time_B = 0.0
        self.time_Bt = 0.0
        self.time_NNt = 0.0
        self.applies = 0

    def prepare(self, splitted) -> None:
        """Refreshes the device operands from a prepared
        SplittedNormalMatrix (same math as its host _apply)."""
        N = splitted.N.tocsc()
        N_csr = N.tocsr()
        self._basis = splitted._basis
        put = self.jax.device_put
        # N' w: one value per nnz, segment = column (CSC order is
        # column-sorted); N u: segment = row (CSR order)
        self._nt_args = put(self._opNt.pack(N.indptr, N.indices, N.data))
        self._n_args = put(self._opN.pack(N_csr.indptr, N_csr.indices,
                                          N_csr.data))
        self._uscale = np.asarray(splitted.uscale)
        self._freepos = np.asarray(splitted.free_positions)
        if self._fn is None:
            self._build()

    def _build(self):
        jax = self.jax
        opN, opNt = self._opN, self._opNt

        def nnt(nt_args, n_args, w):
            u = apply_csr(nt_args, opNt.num_segments, w)     # N' w
            return apply_csr(n_args, opN.num_segments, u)    # N (N' w)

        self._fn = jax.jit(nnt)

    # -- one operator application: host B solves + device NNt -------------
    def _apply(self, v):
        jax = self.jax
        s = self._uscale
        t0 = perf_counter()
        w = self._basis.solve_dense(v / s, "T")
        self.time_Bt += perf_counter() - t0
        t0 = perf_counter()
        z = self._fn(self._nt_args, self._n_args,
                     self.jax.numpy.asarray(w))
        z = np.asarray(z)
        self.applies += 1
        self.time_NNt += perf_counter() - t0
        t0 = perf_counter()
        y = self._basis.solve_dense(z, "N")
        self.time_B += perf_counter() - t0
        out = y / s + v
        if self._freepos.size:
            out[self._freepos] = 0.0
        return out

    def solve(self, rhs: np.ndarray, tol: float, maxiter: int,
              deadline: float = 0.0, warm: np.ndarray = None):
        """Returns (lhs, iters, errflag); contract of the native cr_basis
        (inf-norm termination, 201 iter limit, 202 not posdef, 205 nan,
        999 past `deadline` in time.monotonic() seconds). `warm` optionally
        starts from a slot-space solution of the SAME prepared operator,
        kept only when its residual beats the zero start."""
        from time import monotonic
        m = self.m
        if maxiter < 0:
            maxiter = m + 100
        self.time_B = self.time_Bt = self.time_NNt = 0.0
        rhs = np.asarray(rhs, dtype=np.float64)
        lhs = np.zeros(m)
        r = rhs.copy()
        if warm is not None and np.all(np.isfinite(warm)):
            Cw = self._apply(np.asarray(warm, dtype=np.float64))
            rw = rhs - Cw
            if np.max(np.abs(rw)) < np.max(np.abs(rhs)):
                lhs = np.asarray(warm, dtype=np.float64).copy()
                r = rw
        Cr = self._apply(r)
        cdot = float(r @ Cr)
        d = r.copy()
        cd = Cr.copy()
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
            if deadline > 0.0 and it % 5 == 0 and monotonic() > deadline:
                err = 999
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
            lhs += alpha * d
            r -= alpha * cd
            Cr = self._apply(r)
            cdot_new = float(r @ Cr)
            beta = cdot_new / cdot
            d = r + beta * d
            cd = Cr + beta * cd
            denom = float(cd @ cd)
            cdot = cdot_new
            it += 1
        return lhs, it, err
