"""The device SpMV (take + sorted segment_sum) against scipy's f64 product.

Tolerances are relative to |A| W |A'| |v|, the natural scale of each entry:
1e-12 in f64 and 1e-5 in f32. Both allow for a summation order other than
scipy's (a GPU scatter-add adds in an order that can change between runs).
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ipx_tpu.ops.spmv import NormalMatrixDevice, apply_csr, segment_ids
import ipx_tpu.testgen as tg

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _matrix_with_empties(seed=0):
    """A sparse matrix with empty rows and empty columns."""
    rng = np.random.default_rng(seed)
    A = sp.random(60, 90, density=0.08, random_state=np.random.RandomState(
        seed), format="lil")
    A[[3, 17, 59], :] = 0.0          # empty rows, the last one included
    A[:, [0, 44, 89]] = 0.0          # empty columns, the first and last
    A = A.tocsc()
    A.eliminate_zeros()
    A.data = rng.uniform(-3.0, 3.0, size=A.nnz)
    assert np.diff(A.tocsr().indptr)[[3, 17, 59]].max() == 0
    assert np.diff(A.indptr)[[0, 44, 89]].max() == 0
    return A


def _check(A, B, dt, seed=1):
    m, n = A.shape
    rng = np.random.default_rng(seed)
    shape = (m,) if B == 1 else (m, B)
    W = 10.0 ** rng.uniform(-3, 3, size=(n + m,) + shape[1:])
    V = rng.standard_normal(shape)
    ref = A @ (W[:n] * (A.T @ V)) + W[n:] * V
    absA = abs(A)
    scale = absA @ (W[:n] * (absA.T @ np.abs(V))) + W[n:] * np.abs(V)
    nmd = NormalMatrixDevice(A, dtype=dt)
    out = jax.jit(nmd.apply_batched)(jnp.asarray(W, dt), jnp.asarray(V, dt))
    assert out.shape == shape and out.dtype == dt
    err = np.max(np.abs(np.asarray(out, dtype=np.float64) - ref)
                 / np.maximum(scale, 1e-300))
    assert err <= TOL[dt], err


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("B", [1, 256])
def test_normal_apply_matches_scipy(B, dt):
    data = tg.transportation(120, 180, 0.05, seed=4)
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]),
                      shape=(data["num_constr"], data["num_var"]))
    _check(A, B, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("B", [1, 256])
def test_normal_apply_empty_rows_and_columns(B, dt):
    _check(_matrix_with_empties(), B, dt)


@pytest.mark.parametrize("B", [1, 5])
def test_padded_operand_matches_unpadded(B):
    """An operand padded to a larger capacity (zero values, segment id
    num_segments) gives the same product: padding is dropped."""
    A = _matrix_with_empties(seed=3).tocsr()
    m, n = A.shape
    cap = A.nnz + 37
    idx = np.zeros(cap, dtype=np.int32)
    idx[:A.nnz] = A.indices
    vals = np.zeros(cap)
    vals[:A.nnz] = A.data
    seg = segment_ids(A.indptr, cap, m)
    assert np.all(seg[A.nnz:] == m)
    op = dict(idx=jnp.asarray(idx), vals=jnp.asarray(vals),
              seg=jnp.asarray(seg))
    rng = np.random.default_rng(0)
    U = rng.standard_normal((n,) if B == 1 else (n, B))
    out = np.asarray(apply_csr(op, m, jnp.asarray(U)))
    np.testing.assert_allclose(out, A @ U, rtol=1e-13, atol=1e-13)


def test_segment_ids():
    indptr = np.array([0, 2, 2, 5])
    np.testing.assert_array_equal(segment_ids(indptr, 7, 3),
                                  [0, 0, 2, 2, 2, 3, 3])
