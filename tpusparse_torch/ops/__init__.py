"""Public compute surface: ``spmv`` / ``spmm`` dispatch over formats.

``a`` is a dense array (numpy or tensor) or a compute format
(``SellMatrix``, ``AwspMatrix``, ``RsellMatrix``, ``AspMatrix``,
``BsrMatrix``, ``TcsrMatrix``, ``DiaMatrix``, ``EllMatrix``,
``BellMatrix``, ``BinnedSellMatrix``, or whichever ``auto_format`` picks);
each format carries its kernels. Dense
arrays go to ``dense_torch``. ``CsrMatrix`` is interchange-only and is
rejected: pack it first.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.kernels.dense import dense_torch
from tpusparse_torch.utils import resolve_device


def _is_dense(a: Any) -> bool:
    return isinstance(a, (np.ndarray, torch.Tensor))


def _check_compute_format(a: Any) -> None:
    if isinstance(a, CsrMatrix):
        raise TypeError(
            "CsrMatrix is an interchange format (no kernel gathers through "
            "raw row pointers); pack it first, e.g. SellMatrix.from_csr(csr) "
            "— every compute format packs from CSR without densifying")


def _dense(a: Any, x: Any, device) -> torch.Tensor:
    # a tensor keeps its device; a host array goes to `device` (None: GPU)
    dev = a.device if isinstance(a, torch.Tensor) else resolve_device(device)
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    return dense_torch(a, torch.as_tensor(x, dtype=torch.float32, device=dev))


def spmv(a: Any, x: Any, *, device=None) -> torch.Tensor:
    """y = x @ a for a single vector x of shape (m,). ``device`` places a
    numpy ``a`` (None: the GPU); tensors and formats keep their own."""
    if _is_dense(a):
        return _dense(a, x, device)
    _check_compute_format(a)
    return a.spmv(x)


def spmm(a: Any, x: Any, *, device=None) -> torch.Tensor:
    """Y = X @ a for batched X of shape (b, m)."""
    if _is_dense(a):
        return _dense(a, x, device)
    _check_compute_format(a)
    return a.spmm(x)
