"""Bandwidth-reduction reordering: reverse Cuthill-McKee (RCM).

Counterpart of ``tpusparse/reorder.py``, host-side numpy and scipy, with
the same permutations and CSRs bit for bit. Banded operators rarely
arrive banded: a mesh's numbering scatters a local operator's nonzeros
over thousands of diagonals. A symmetric permutation
``B[i, j] = A[p[i], p[j]]`` from RCM can recover the band and with it the
DIA route (K8). The pattern is two-space: permute once, solve every
iteration in B-space, unpermute once:

    csr_b, p = reorder.rcm(csr)           # once, on the host
    fmt = auto_format(csr_b)              # now routes to DIA
    z_b, info = solve.cg(fmt, b[p])       # every iteration in B-space
    z = reorder.unpermute_vector(z_b, p)  # once
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix

__all__ = ["bandwidth_csr", "rcm", "banded_after_rcm",
           "inverse_permutation", "permute_vector", "unpermute_vector"]


def bandwidth_csr(csr: CsrMatrix) -> int:
    """Max ``|i - j|`` over stored entries (the half-bandwidth), O(nnz)."""
    if csr.nnz == 0:
        return 0
    r = np.repeat(np.arange(csr.shape[1], dtype=np.int64), csr.row_nnz)
    return int(np.abs(csr.col_idx.astype(np.int64) - r).max())


def rcm(csr: CsrMatrix) -> tuple[CsrMatrix, np.ndarray]:
    """Reverse Cuthill-McKee on the symmetrised pattern of square ``A``.
    Returns ``(csr_b, p)`` with ``B[i, j] = A[p[i], p[j]]``, so that
    ``(x @ A)[p] == x[p] @ B``."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = csr.shape
    if m != n:
        raise ValueError(f"rcm needs a square matrix, got {csr.shape}")
    s = csr.to_scipy().tocsr()
    p = np.asarray(reverse_cuthill_mckee(s, symmetric_mode=False),
                   dtype=np.int64)
    b = s[p][:, p]
    return CsrMatrix.from_scipy(b), p


def banded_after_rcm(
        csr: CsrMatrix) -> tuple[CsrMatrix, np.ndarray] | None:
    """RCM, kept only when the reordered system passes the router's DIA
    rule (at most 512 distinct diagonals, diagonal storage within 1.25x of
    5 bytes an nnz): ``(csr_b, p)``, else None. The gate counts diagonals,
    not bandwidth: RCM gives a 2-D Laplacian a bandwidth of ~sqrt(n) over
    ~2 sqrt(n) distinct offsets, which DIA would not serve well."""
    csr_b, p = rcm(csr)
    m, n = csr_b.shape
    r = np.repeat(np.arange(n, dtype=np.int64), csr_b.row_nnz)
    k = int(np.unique(csr_b.col_idx.astype(np.int64) - r).size)
    if 0 < k <= 512 and 4 * k * n <= 1.25 * 5 * csr_b.nnz:
        return csr_b, p
    return None


def inverse_permutation(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(np.asarray(p))
    inv[p] = np.arange(len(p))
    return inv


def _index(v, p: np.ndarray):
    """``p`` as an index for ``v``: a tensor on v's device for a tensor."""
    if isinstance(v, torch.Tensor):
        return torch.from_numpy(np.asarray(p, dtype=np.int64)).to(v.device)
    return np.asarray(p)


def permute_vector(v, p):
    """``v`` (numpy or tensor) in A-space -> B-space, ``out[i] = v[p[i]]``.
    Once a solve, not once an iteration."""
    return v[_index(v, p)]


def unpermute_vector(v, p):
    """``v`` in B-space -> A-space, ``out[p[i]] = v[i]``."""
    return v[_index(v, inverse_permutation(np.asarray(p)))]
