"""float64 numpy oracles of ``Y = X @ A`` (``Y[i] = sum_j X[j] A[j, i]``):
``sgemv_cpu``/``sgemm_cpu`` on a dense A, cast back to A's dtype, and
``csr_spmm_cpu`` on the CSR of A.T (A never densified), in float64."""

from __future__ import annotations

import numpy as np


def sgemv_cpu(x: np.ndarray, a: np.ndarray) -> np.ndarray:
    """x: (m,), a: (m, n) -> (n,)."""
    if not (x.ndim == 1 and a.ndim == 2 and x.shape[0] == a.shape[0]):
        raise ValueError(f"sgemv_cpu: x {x.shape} vs a {a.shape}")
    return (x.astype(np.float64) @ a.astype(np.float64)).astype(a.dtype)


def sgemm_cpu(x: np.ndarray, a: np.ndarray) -> np.ndarray:
    """x: (b, m), a: (m, n) -> (b, n)."""
    if not (x.ndim == 2 and a.ndim == 2 and x.shape[1] == a.shape[0]):
        raise ValueError(f"sgemm_cpu: x {x.shape} vs a {a.shape}")
    return (x.astype(np.float64) @ a.astype(np.float64)).astype(a.dtype)


def csr_spmm_cpu(x: np.ndarray, csr) -> np.ndarray:
    """x: (m,) or (b, m), ``csr`` a ``CsrMatrix`` of A (m, n) -> (n,) or
    (b, n) in float64, through scipy."""
    at = csr.to_scipy().T.tocsr().astype(np.float64)
    x = np.asarray(x, np.float64)
    return (at @ x.T).T if x.ndim == 2 else at @ x
