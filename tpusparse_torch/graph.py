"""Graph operators: the sparse-matrix on-ramp for GNN workloads.

Counterpart of ``tpusparse/graph.py``; the same numpy code, so the operator
is the JAX package's bit for bit.

A graph convolution is literally this library's op: ``H' = sigma(W @ (H A))``
with ``A`` the (fixed, sparse) normalized adjacency — SpMM against a frozen
operator, which ``autodiff.linear_map`` already differentiates. What a GNN
user additionally needs is the O(nnz) construction of that operator from an
edge list, without ever densifying:

    A_hat = D^{-1/2} (A + I) D^{-1/2}      (Kipf & Welling GCN normalization)
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.formats.csr import CsrMatrix


def normalized_adjacency(csr: CsrMatrix, *, add_self_loops: bool = True,
                         dtype=np.float32) -> CsrMatrix:
    """GCN symmetric normalization ``D^{-1/2} (A + I) D^{-1/2}`` in O(nnz).

    ``csr`` must be square and should be an UNDIRECTED (symmetric-pattern)
    adjacency — degrees are weighted row sums, taken over the m axis. Rows
    isolated even after self-loops get degree 1 (their rows are zero either
    way). Never materializes an (n, n) dense array.
    """
    m, n = csr.shape
    if m != n:
        raise ValueError(f"adjacency must be square, got {m}x{n}")
    # entry streams: A[mi[k], r[k]] = v[k]  (CSR of A.T layout, csr.py:86)
    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    v = csr.values.astype(np.float64)    # astype copies; safe to mutate

    if add_self_loops:
        diag = mi == r
        have = np.zeros(n, dtype=bool)
        have[r[diag]] = True
        v[diag] += 1.0
        missing = np.flatnonzero(~have)
        mi = np.concatenate([mi, missing])
        r = np.concatenate([r, missing])
        v = np.concatenate([v, np.ones(missing.size)])

    deg = np.bincount(mi, weights=v, minlength=n)
    dinv_sqrt = 1.0 / np.sqrt(np.where(deg > 0, deg, 1.0))
    v = v * dinv_sqrt[mi] * dinv_sqrt[r]
    return CsrMatrix.from_coo(n, n, mi, r, v.astype(dtype))
