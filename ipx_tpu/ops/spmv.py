"""Sparse matrix products on the device: take + sorted segment_sum.

For a CSR matrix (row-sorted nonzeros) and U of shape (n,) or (n, B):

    A @ U  =  segment_sum(vals * U[cols], rows, m)

One formulation serves a single vector (the phase-1 device CR), a batch of
B vectors (the scenario fleet) and the per-device blocks of the sharded
paths (ipx_tpu.parallel.sharding). Each apply reads the nonzero stream
once: one gather, one multiply, one sorted segment reduction.

Padding: an operand may be padded to a fixed capacity with zero values and
segment id `num_segments`, which segment_sum drops, so one compiled program
serves operands of different nnz.

On a GPU segment_sum lowers to a scatter-add whose order of summation can
change from run to run, so results agree with a sequential sum to rounding
(a few ulps times the row length), not bit for bit.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def segment_ids(indptr: np.ndarray, cap: int, fill: int) -> np.ndarray:
    """Segment (row) id of each nonzero of a CSR-style pointer array,
    padded to `cap` entries with `fill`."""
    nnz = int(indptr[-1])
    seg = np.full(cap, fill, dtype=np.int32)
    seg[:nnz] = np.repeat(np.arange(len(indptr) - 1, dtype=np.int32),
                          np.diff(indptr).astype(np.int64))
    return seg


def operand(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
            num_segments: int, dtype=np.float64):
    """Device arrays of one CSR direction as a pytree (a jit argument, so
    compiled programs carry no data constants)."""
    import jax.numpy as jnp
    return dict(idx=jnp.asarray(np.asarray(indices, dtype=np.int32)),
                vals=jnp.asarray(np.asarray(data, dtype=dtype)),
                seg=jnp.asarray(segment_ids(indptr, len(data),
                                            num_segments)))


def apply_csr(op, num_segments: int, U):
    """A @ U for U of shape (len,) or (len, B); `op` from operand()."""
    import jax
    import jax.numpy as jnp
    g = jnp.take(U, op["idx"], axis=0)
    vals = op["vals"] if U.ndim == 1 else op["vals"][:, None]
    return jax.ops.segment_sum(vals * g, op["seg"],
                               num_segments=num_segments,
                               indices_are_sorted=True)


def normal_apply(tree, n: int, W, V):
    """AI W AI' V = A (W_struct * (A' V)) + W_slack * V for V of shape (m,)
    or (m, B), with W of the same rank; n is the structural column count
    (static)."""
    U = apply_csr(tree["At"], n, V) * W[:n]
    return apply_csr(tree["A"], W.shape[0] - n, U) + W[n:] * V


class NormalMatrixDevice:
    """Device-resident operands of AI W AI' for one matrix and dtype:
    `tree` holds the CSR operand of A ("A") and of A' ("At")."""

    def __init__(self, A_csc: sp.csc_matrix, dtype=np.float64):
        A_csr = A_csc.tocsr()
        A_csr.sort_indices()
        m, n = A_csc.shape
        self.m, self.n = m, n
        self.dtype = dtype
        self.tree = dict(
            A=operand(A_csr.indptr, A_csr.indices, A_csr.data, m, dtype),
            At=operand(A_csc.indptr, A_csc.indices, A_csc.data, n, dtype))

    def apply_batched_struct(self, U):
        """Structural product A @ U."""
        return apply_csr(self.tree["A"], self.m, U)

    def applyT_batched_struct(self, V):
        """Structural product A' @ V."""
        return apply_csr(self.tree["At"], self.n, V)

    def apply_batched(self, W, V):
        """AI W AI' V."""
        return normal_apply(self.tree, self.n, W, V)
