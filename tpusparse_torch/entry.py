"""The port's entry point: the flagship SpMV as ``(fn, example_args)``.

Counterpart of ``__graft_entry__.entry``: SELL (K1,
``kernels/sell_spmv.py``) at 1024 x 1024, density 0.5, seed 0, one
vector. ``fn(*args)`` is ``y = x @ A``.
"""

from __future__ import annotations

import torch

from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import resolve_device

M = N = 1024
DENSITY = 0.5
SEED = 0


def _spmv(fmt: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    return fmt.spmv(x)


def entry(device=None):
    """``(fn, (pack, x))`` on ``device`` (None: the GPU); the matrix and
    vector are the JAX entry's bits."""
    dev = resolve_device(device)
    a = generators.random_sparse_matrix(M, N, density=DENSITY, seed=SEED)
    x = generators.random_sparse_vector(M, density=DENSITY, seed=SEED)
    return _spmv, (SellMatrix.from_dense(a, device=dev),
                   torch.from_numpy(x).to(dev))
