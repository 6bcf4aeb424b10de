"""Dense -> sparse pruning: the on-ramp from a trained dense weight.

Counterpart of ``tpusparse/prune.py``: the same numpy code, so every result
is the JAX package's bit for bit. Host-side one-shot converters returning a
``CsrMatrix``, from which any packed format, ``nn.SparseLinear`` or
``autodiff.trainable_linear`` is built. ``a`` is A, shape (in, out), the
transpose of an ``nn.Linear`` weight, as a numpy array or as a tensor on
any device (copied to the host).

- ``magnitude_prune`` — unstructured top-|a|; ``per_column=True`` keeps the
  same count in every output column, which bounds the SELL width W and so
  the padding (``formats/sell.py``).
- ``nm_prune`` — N:M along the contraction axis: with M dividing 128, every
  128-row window of every column holds exactly ``128*N/M`` nonzeros, so the
  SELL pack carries no padding.
- ``block_prune`` — keeps the strongest (block_m x block_n) blocks, the
  BSR/TCSR tile grid (``formats/bsr.py``), whose kept tiles K6 reads whole.

All three keep values exactly (no rescaling); fine-tuning after pruning is
the usual recipe, with ``trainable_linear`` training the kept values with
the mask frozen.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.formats.csr import (CsrMatrix, _host_numpy,
                                        col_window_widths)


def _as_dense(a) -> np.ndarray:
    a = _host_numpy(a)
    if a.ndim != 2:
        raise ValueError(f"expected a 2-D weight, got shape {a.shape}")
    return a


def magnitude_prune(a, density: float, *,
                    per_column: bool = True) -> CsrMatrix:
    """Keep the largest-|a| entries at the target ``density`` in (0, 1].

    ``per_column=True`` (default) keeps the SAME count in every output
    column (column of A = row of this CSR-of-A.T): SELL pads every column
    to the widest one per 128-window, so per-column balance converts
    directly into less padding and a smaller W. ``False`` ranks globally
    (minimum-error choice when column balance does not matter, e.g. for
    BSR routing).
    """
    a = _as_dense(a)
    m, n = a.shape
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    mag = np.abs(a)
    if per_column:
        k = max(1, int(round(density * m)))
        # top-k per column of A -> mask
        part = np.argpartition(-mag, k - 1, axis=0)[:k]      # (k, n)
        mask = np.zeros_like(a, dtype=bool)
        mask[part, np.arange(n)[None, :]] = True
    else:
        k = max(1, int(round(density * a.size)))
        thresh_idx = np.argpartition(-mag.ravel(), k - 1)[:k]
        mask = np.zeros(a.size, dtype=bool)
        mask[thresh_idx] = True
        mask = mask.reshape(a.shape)
    mask &= a != 0  # never keep stored zeros
    return CsrMatrix.from_dense(np.where(mask, a, 0).astype(a.dtype))


def nm_prune(a, n_keep: int = 2, m_group: int = 4) -> CsrMatrix:
    """N:M structured pruning: in every ``m_group`` consecutive entries
    ALONG THE CONTRACTION AXIS (axis 0 of A), keep the ``n_keep``
    largest-|a|.

    With ``m_group`` dividing 128, every 128-lane SELL window of every
    column holds exactly ``128 * n_keep / m_group`` nonzeros -> the packed
    width is uniform and padding-free. The classic (2, 4) gives d=0.5 at
    W=64 per window.
    """
    a = _as_dense(a)
    m, n = a.shape
    if not 0 < n_keep <= m_group:
        raise ValueError(f"need 0 < n_keep <= m_group, got "
                         f"({n_keep}, {m_group})")
    if m % m_group:
        raise ValueError(f"contraction dim {m} not divisible by "
                         f"m_group={m_group}")
    groups = np.abs(a).reshape(m // m_group, m_group, n)
    # smallest (m_group - n_keep) per group get dropped
    order = np.argsort(groups, axis=1)                 # ascending |a|
    drop = order[:, : m_group - n_keep, :]             # (mg, drop, n)
    mask = np.ones_like(groups, dtype=bool)
    gi = np.arange(m // m_group)[:, None, None]
    ci = np.arange(n)[None, None, :]
    mask[gi, drop, ci] = False
    mask = mask.reshape(m, n) & (a != 0)
    return CsrMatrix.from_dense(np.where(mask, a, 0).astype(a.dtype))


def block_prune(a, density: float, *, block_m: int = 128,
                block_n: int = 128) -> CsrMatrix:
    """Keep the (block_m x block_n) blocks with the largest Frobenius
    norms at the target BLOCK density; everything inside a kept block
    survives. Defaults match the BSR tile grid (formats/bsr.py: block_m x
    128 dense MXU tiles), so ``BsrMatrix.from_csr`` of the result skips
    exactly the pruned blocks. Ragged edges (shape not divisible by the
    block) are padded with zeros for ranking only.
    """
    a = _as_dense(a)
    m, n = a.shape
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    mb, nb = -(-m // block_m), -(-n // block_n)
    ap = np.zeros((mb * block_m, nb * block_n), dtype=a.dtype)
    ap[:m, :n] = a
    tiles = ap.reshape(mb, block_m, nb, block_n)
    norms = np.sqrt((tiles.astype(np.float64) ** 2).sum(axis=(1, 3)))
    k = max(1, int(round(density * mb * nb)))
    keep_flat = np.argpartition(-norms.ravel(), k - 1)[:k]
    bmask = np.zeros(mb * nb, dtype=bool)
    bmask[keep_flat] = True
    bmask &= norms.ravel() > 0                # never keep all-zero blocks
    full = np.repeat(np.repeat(bmask.reshape(mb, nb), block_m, axis=0),
                     block_n, axis=1)[:m, :n]
    return CsrMatrix.from_dense(np.where(full, a, 0).astype(a.dtype))


def summary(csr: CsrMatrix, window: int = 128) -> dict:
    """Packing-relevant stats of a pruned matrix: density, per-column nnz
    spread, and the SELL width/padding the mask implies."""
    m, n = csr.shape
    col_w = col_window_widths(csr, window)
    w = int(col_w.max()) if col_w.size else 0
    windows = -(-m // window)
    slots = w * windows * n
    return {
        "shape": (m, n),
        "nnz": csr.nnz,
        "density": csr.nnz / max(m * n, 1),
        "col_nnz_min": int(csr.row_nnz.min()) if n else 0,
        "col_nnz_max": int(csr.row_nnz.max()) if n else 0,
        "sell_w": w,
        "sell_pad_frac": 0.0 if slots == 0 else 1.0 - csr.nnz / slots,
    }
