"""Weights across: rebuild a JAX-package pack as the port's object.

``from_reference_arrays`` takes the plain numpy leaves and metadata of a
``tpusparse`` ``SellMatrix``, ``AwspMatrix``, ``BsrMatrix``, ``TcsrMatrix``,
``DiaMatrix``, ``EllMatrix``, ``BellMatrix``, ``BinnedSellMatrix``,
``RsellMatrix`` or ``AspMatrix`` and returns the port's counterpart on
``device``. It
imports nothing of the JAX package; whoever holds the JAX object extracts
the dict:

    {"kind": "sell" | "awsp", "idx", "vals", "scales", "shape", "padded",
     "w", "nnz", "g"}
    {"kind": "bsr", "bi", "bj", "blocks", "shape", "padded", "block_m",
     "nnz", "n_real"}
    {"kind": "tcsr", "s_bi", "s_bj", "idx", "vals", "w", "bsr", "shape",
     "padded", "nnz", "n_sell", "n_dense"}
    {"kind": "dia", "offsets", "vals", "shape", "nnz", "sym", "xla_only"}
    {"kind": "ell", "idx", "val", "shape", "nnz"}
    {"kind": "bell", "bitmap", "carries", "vals", "shape", "padded",
     "block_m", "w", "nnz"}
    {"kind": "binned", "idx" (list, one per bucket), "vals" (list),
     "inv_perm", "shape", "nnz", "widths"}
    {"kind": "rsell", "cj", "ct", "idx", "vals", "shape", "padded", "nnz",
     "n_real", "w_max", "run", "inv_perm"}
    {"kind": "asp", "a_pad", "shape", "block_n"}

``scales`` is None except for int8 SELL storage; ``g`` is read for AWSP
only; DIA's ``xla_only`` and RSELL's ``run`` (1) and ``inv_perm`` (None:
an unsorted pack) may be left out. TCSR's ``bsr`` is the dense tier as a
BSR dict (its ``kind`` may be left out) or None. BELL's ``bitmap`` is the
uint32 words. The unpermute plans of binned SELL and of a sorted RSELL
pack are rebuilt from ``inv_perm`` (the JAX package's ``permute_plan``,
the same arrays). bf16 values arrive as a
``uint16`` view of their bits (numpy has no bf16 of its own).

``load_trainable_arrays`` carries trained values the same way: the numpy
leaves of a JAX ``trainable_linear``'s params (``{"vals", "vals_t"}``) or of
a flax ``SparseLinear`` param subtree (plus ``"bias"``), copied into the
port's ``params`` dict or ``SparseLinear`` module built from the same CSR,
so a layer trained in JAX goes on training here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.formats.bell import BellMatrix
from tpusparse_torch.formats.binned import BinnedSellMatrix
from tpusparse_torch.formats.bsr import BsrMatrix
from tpusparse_torch.formats.dia import DiaMatrix
from tpusparse_torch.formats.ell import EllMatrix
from tpusparse_torch.formats.rsell import RsellMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.formats.tcsr import TcsrMatrix
from tpusparse_torch.kernels.asp_spmv import AspMatrix
from tpusparse_torch.kernels.permute import permute_plan
from tpusparse_torch.utils import resolve_device


def _values(v: np.ndarray) -> torch.Tensor:
    v = np.ascontiguousarray(v)
    if v.dtype == np.uint16:                      # bf16 bits
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(v)


# the leaves and metadata each kind's dict must hold
_KEYS = {
    "sell": ("idx", "vals", "shape", "padded", "w", "nnz"),
    "awsp": ("idx", "vals", "shape", "padded", "w", "nnz", "g"),
    "bsr": ("bi", "bj", "blocks", "shape", "padded", "block_m", "nnz",
            "n_real"),
    "tcsr": ("s_bi", "s_bj", "idx", "vals", "w", "bsr", "shape", "padded",
             "nnz", "n_sell", "n_dense"),
    "dia": ("offsets", "vals", "shape", "nnz", "sym"),
    "ell": ("idx", "val", "shape", "nnz"),
    "bell": ("bitmap", "carries", "vals", "shape", "padded", "block_m", "w",
             "nnz"),
    "binned": ("idx", "vals", "inv_perm", "shape", "nnz", "widths"),
    "rsell": ("cj", "ct", "idx", "vals", "shape", "padded", "nnz", "n_real",
              "w_max"),
    "asp": ("a_pad", "shape", "block_n"),
}


def _check_keys(kind: str, d: dict[str, Any]) -> None:
    if kind not in _KEYS:
        raise ValueError(f"unknown pack kind {kind!r}: one of "
                         f"{', '.join(map(repr, _KEYS))}")
    missing = [k for k in _KEYS[kind] if k not in d]
    if missing:
        raise ValueError(f"{kind!r} pack lacks {missing}")


def _ints(v) -> tuple[int, ...]:
    return tuple(int(s) for s in v)


def _tensor(v, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v, dtype=dtype))


def _bsr(d: dict[str, Any], dev: torch.device) -> BsrMatrix:
    _check_keys("bsr", d)
    return BsrMatrix(_tensor(d["bi"], np.int32).to(dev),
                     _tensor(d["bj"], np.int32).to(dev),
                     _tensor(d["blocks"], np.float32).to(dev),
                     _ints(d["shape"]), _ints(d["padded"]),
                     int(d["block_m"]), int(d["nnz"]), int(d["n_real"]))


def _rsell(d: dict[str, Any], dev: torch.device) -> RsellMatrix:
    inv_perm, plan = d.get("inv_perm"), None
    if inv_perm is not None:
        inv_perm = np.ascontiguousarray(inv_perm, dtype=np.int32)
        pp = permute_plan(inv_perm)
        plan = (pp["oidx"], pp["oh"])
    return RsellMatrix(_tensor(d["cj"], np.int32).to(dev),
                       _tensor(d["ct"], np.int32).to(dev),
                       _tensor(d["idx"], np.int8).to(dev),
                       _values(d["vals"]).to(dev), _ints(d["shape"]),
                       _ints(d["padded"]), int(d["nnz"]), int(d["n_real"]),
                       int(d["w_max"]), run=int(d.get("run", 1)),
                       inv_perm=inv_perm, perm_plan=plan)


def from_reference_arrays(d: dict[str, Any], device=None):
    """JAX-package pack leaves -> ``SellMatrix``, ``AwspMatrix``,
    ``BsrMatrix``, ``TcsrMatrix``, ``DiaMatrix``, ``EllMatrix``,
    ``BellMatrix``, ``BinnedSellMatrix``, ``RsellMatrix`` or ``AspMatrix``
    on ``device`` (None is the GPU)."""
    dev = resolve_device(device)
    kind = d["kind"]
    _check_keys(kind, d)
    if kind == "bsr":
        return _bsr(d, dev)
    if kind == "tcsr":
        bsr = None if d["bsr"] is None else _bsr(d["bsr"], dev)
        return TcsrMatrix(_tensor(d["s_bi"], np.int32).to(dev),
                          _tensor(d["s_bj"], np.int32).to(dev),
                          _tensor(d["idx"], np.int8).to(dev),
                          _tensor(d["vals"], np.float32).to(dev),
                          int(d["w"]), bsr, _ints(d["shape"]),
                          _ints(d["padded"]), int(d["nnz"]),
                          int(d["n_sell"]), int(d["n_dense"]))
    if kind == "dia":
        return DiaMatrix(_ints(d["offsets"]),
                         _tensor(d["vals"], np.float32).to(dev),
                         _ints(d["shape"]), int(d["nnz"]),
                         sym=bool(d["sym"]),
                         xla_only=bool(d.get("xla_only", False)))
    if kind == "ell":
        return EllMatrix(_tensor(d["idx"], np.int32).to(dev),
                         _tensor(d["val"], np.float32).to(dev),
                         _ints(d["shape"]), int(d["nnz"]))
    if kind == "bell":
        bits = np.ascontiguousarray(d["bitmap"], dtype=np.uint32)
        return BellMatrix(torch.from_numpy(bits.view(np.int32)).to(dev),
                          _tensor(d["carries"], np.int32).to(dev),
                          _tensor(d["vals"], np.float32).to(dev),
                          _ints(d["shape"]), _ints(d["padded"]),
                          int(d["block_m"]), int(d["w"]), int(d["nnz"]))
    if kind == "binned":
        buckets = [{"idx": _tensor(i, np.int8).to(dev),
                    "vals": _tensor(v, np.float32).to(dev)}
                   for i, v in zip(d["idx"], d["vals"], strict=True)]
        inv_perm = np.ascontiguousarray(d["inv_perm"], dtype=np.int32)
        pp = permute_plan(inv_perm)
        return BinnedSellMatrix(buckets, inv_perm, (pp["oidx"], pp["oh"]),
                                _ints(d["shape"]), int(d["nnz"]),
                                _ints(d["widths"]))
    if kind == "rsell":
        return _rsell(d, dev)
    if kind == "asp":
        return AspMatrix(_values(d["a_pad"]).to(dev), _ints(d["shape"]),
                         int(d["block_n"]))
    idx = torch.from_numpy(np.ascontiguousarray(d["idx"], dtype=np.int8))
    vals = _values(d["vals"])
    meta = (tuple(int(s) for s in d["shape"]),
            tuple(int(s) for s in d["padded"]), int(d["w"]))
    if kind == "sell":
        scales = d.get("scales")
        if scales is not None:
            scales = torch.from_numpy(
                np.ascontiguousarray(scales, dtype=np.float32)).to(dev)
        return SellMatrix(idx.to(dev), vals.to(dev), *meta, int(d["nnz"]),
                          scales=scales)
    return AwspMatrix(idx.to(dev), vals.to(dev), *meta, int(d["g"]),
                      int(d["nnz"]))


def load_trainable_arrays(target, leaves: dict[str, Any]):
    """Copy JAX-trained leaves into ``target`` in place, after checking
    that the keys, shapes and dtypes (fp32) are those of ``target``'s.
    ``target``: the ``params`` of ``trainable_linear`` (keys ``vals``,
    ``vals_t``) or a ``SparseLinear`` (the same, plus ``bias`` when it has
    one). Returns ``target``."""
    if isinstance(target, torch.nn.Module):
        dst = dict(target.named_parameters(recurse=False))
    else:
        dst = dict(target)
    if set(leaves) != set(dst):
        raise ValueError(f"leaves {sorted(leaves)} do not match the "
                         f"target's parameters {sorted(dst)}")
    for k, t in dst.items():
        v = np.asarray(leaves[k])
        if v.dtype != np.float32 or v.shape != tuple(t.shape):
            raise ValueError(f"{k}: got {v.dtype} {v.shape}, the target "
                             f"holds float32 {tuple(t.shape)}")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(torch.from_numpy(np.ascontiguousarray(leaves[k])))
    return target
