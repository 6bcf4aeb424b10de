"""ELL: per-output-column padded gather format, with no hand-written kernel.

Counterpart of ``tpusparse/formats/ell.py``, with the same pack bit for
bit: ``idx``/``val`` are (n, width), row r holding output column r's
nonzeros (contraction index and value) packed to the left and padded to
the widest column, rounded up to ``pad_to``; pad slots point at index 0
with value 0. ``y[r] = sum_w val[r, w] * x[idx[r, w]]``.

The JAX package computes it with one XLA gather and a row sum, no Pallas
kernel; here it is a torch gather and a row sum on the matrix's device.
It is the repo's cross-check for the block formats (PARITY.md).
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.formats.csr import _host_numpy
from tpusparse_torch.formats.sell import as_input
from tpusparse_torch.utils import resolve_device, round_up


def ell_pack(a, pad_to: int = 8) -> dict:
    """Dense A (numpy or tensor) -> numpy ``idx`` (n, width) int32, ``val``
    (n, width), ``shape`` and ``nnz``."""
    a = _host_numpy(a)
    m, n = a.shape
    at = a.T
    mask = at != 0
    row_nnz = mask.sum(axis=1)
    width = max(round_up(int(row_nnz.max()) if row_nnz.size else 0, pad_to),
                pad_to)
    rank = np.cumsum(mask, axis=1) - mask
    idx = np.zeros((n, width), dtype=np.int32)
    val = np.zeros((n, width), dtype=a.dtype)
    rows, cols = np.nonzero(mask)
    idx[rows, rank[mask]] = cols.astype(np.int32)
    val[rows, rank[mask]] = at[rows, cols]
    return dict(idx=idx, val=val, shape=(m, n), nnz=int(row_nnz.sum()))


class EllMatrix:
    """idx/val: (n, width) tensors on one device."""

    def __init__(self, idx: torch.Tensor, val: torch.Tensor, shape,
                 nnz: int):
        self.idx = idx
        self.val = val
        self.shape = tuple(shape)
        self.nnz = nnz

    @property
    def device(self) -> torch.device:
        return self.val.device

    def __repr__(self) -> str:
        return (f"EllMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"width={self.idx.shape[1]}, device={self.device}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_dense(cls, a, pad_to: int = 8, device=None) -> "EllMatrix":
        """Dense A (numpy or tensor) on ``device`` (None: the GPU)."""
        dev = resolve_device(device)
        p = ell_pack(a, pad_to=pad_to)
        return cls(torch.from_numpy(p["idx"]).to(dev),
                   torch.from_numpy(p["val"]).to(dev), p["shape"], p["nnz"])

    def device_bytes(self) -> int:
        val = self.val
        return self.idx.numel() * 4 + val.numel() * val.element_size()

    def to_dense(self) -> torch.Tensor:
        """Dense A on the host (pads add 0 at row 0)."""
        m, n = self.shape
        at = torch.zeros((n, m), dtype=self.val.dtype)
        at.scatter_add_(1, self.idx.cpu().long(), self.val.cpu())
        return at.T.contiguous()

    def spmv(self, x) -> torch.Tensor:
        """x: (m,) -> y = x @ A, (n,)."""
        x = as_input(x, self.device)
        return (self.val * x[self.idx.long()]).sum(dim=1)

    def spmm(self, x) -> torch.Tensor:
        """x: (b, m) -> Y = X @ A, (b, n)."""
        x = as_input(x, self.device)
        return (self.val[None] * x[:, self.idx.long()]).sum(dim=2)
