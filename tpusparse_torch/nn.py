"""``SparseLinear``: a ``torch.nn.Module`` whose weight is a SELL-packed
matrix with a frozen sparsity mask and trainable values.

Counterpart of ``tpusparse/nn.py``, in PyTorch's idiom: the JAX version is a
flax class factory, this is a module instance. Its parameters are named as
flax names them, ``vals``, ``vals_t`` and (``use_bias=True``) ``bias``, so
``state_dict()`` holds exactly the flax param subtree; the structure planes
and the masks are buffers left out of it (``persistent=False``), since the
sparsity pattern fixes them. Forward and backward run through
``autodiff.TwinSell``: K1 forward, K1 through the transpose layout for dx
and K10 for both value copies. Train it with any ``torch.optim``
optimizer; apply ``masks`` to updates that move parameters without
gradients (weight decay), and call ``resync()`` now and then (every O(10k)
steps, or at checkpoints) to re-tie ``vals_t`` from ``vals`` exactly.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tpusparse_torch.autodiff import TwinSell, _TwinPack, retied, twin_leaves
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.sell import as_input
from tpusparse_torch.utils import resolve_device

_STATICS = ("idx", "idx_t", "s_f", "s_t")


class SparseLinear(torch.nn.Module):
    """``y = activation(x @ A + bias)`` with A's values trainable and its
    mask frozen. ``device=None`` is the GPU."""

    def __init__(self, csr: CsrMatrix, *, use_bias: bool = False,
                 activation: Callable[[torch.Tensor], torch.Tensor]
                 | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        leaves = twin_leaves(_TwinPack(csr), dev)
        self.shape = leaves["shape"]
        self.nnz = int(csr.nnz)
        self.vals = torch.nn.Parameter(leaves["params"]["vals"])
        self.vals_t = torch.nn.Parameter(leaves["params"]["vals_t"])
        self.register_parameter("bias", torch.nn.Parameter(torch.zeros(
            self.shape[1], dtype=torch.float32, device=dev))
            if use_bias else None)
        self.activation = activation
        for name, t in leaves["statics"].items():
            self.register_buffer(name, t, persistent=False)
        self.register_buffer("mask_vals", leaves["masks"]["vals"],
                             persistent=False)
        self.register_buffer("mask_vals_t", leaves["masks"]["vals_t"],
                             persistent=False)
        self.register_buffer("t_gather", leaves["gather"], persistent=False)
        self.register_buffer("t_live", leaves["live"], persistent=False)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, *, use_bias: bool = False,
                 activation: Callable[[torch.Tensor], torch.Tensor]
                 | None = None, device=None) -> "SparseLinear":
        return cls(csr, use_bias=use_bias, activation=activation,
                   device=device)

    @classmethod
    def from_dense(cls, a, **kw: Any) -> "SparseLinear":
        """Dense A (numpy or tensor), shape (in, out): the transpose of an
        ``nn.Linear`` weight."""
        return cls.from_csr(CsrMatrix.from_dense(a), **kw)

    @property
    def masks(self) -> dict[str, torch.Tensor]:
        """True on real slots, in each layout."""
        return {"vals": self.mask_vals, "vals_t": self.mask_vals_t}

    def forward(self, x) -> torch.Tensor:
        statics = {k: getattr(self, k) for k in _STATICS}
        y = TwinSell.apply(self.vals, self.vals_t,
                           as_input(x, self.vals.device), statics, self.shape)
        if self.bias is not None:
            y = y + self.bias
        return self.activation(y) if self.activation is not None else y

    def resync(self) -> None:
        """Re-tie ``vals_t`` from ``vals`` exactly, in place (one gather on
        the device); ``bias`` is left as it is."""
        with torch.no_grad():
            self.vals_t.copy_(retied(self.vals, self.t_gather, self.t_live))

    def extra_repr(self) -> str:
        return (f"shape={self.shape}, nnz={self.nnz}, "
                f"bias={self.bias is not None}")
