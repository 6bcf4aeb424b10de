"""Format persistence: npz save/load of packed formats, in the JAX
package's file layout.

Counterpart of ``tpusparse/formats/io.py``: a file written by either
package loads in the other. A file holds ``kind``, ``meta`` (the repr of
the kind's aux tuple), ``leaf_dtypes`` (the repr of the leaves' dtype
names) and ``leaf0``, ``leaf1``, ... in the order the JAX class's
``tree_flatten`` gives them (its None children dropped). bf16 leaves are
stored as their uint16 bits with the dtype name ``bfloat16``.

The port's classes are not pytrees, so each kind has a pair of hooks
here: ``_LEAVES[kind](fmt) -> (leaves, aux)`` writes the JAX layout, and
``_REBUILD[kind](aux, leaves) -> dict`` reads it into the dict that
``convert.from_reference_arrays`` turns into the port's object on a
device. ``encode``/``decode`` are the file-agnostic halves, reused by
``amg.SmoothedAggregationAMG.save/load`` and by ``to_device``, which
uploads a pack made on the host (the benches time packing and the upload
apart).
"""

from __future__ import annotations

import ast
from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.formats.bell import BellMatrix
from tpusparse_torch.formats.binned import BinnedSellMatrix
from tpusparse_torch.formats.bsr import BsrMatrix
from tpusparse_torch.formats.convert import from_reference_arrays
from tpusparse_torch.formats.dia import DiaMatrix
from tpusparse_torch.formats.rsell import RsellMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.formats.tcsr import TcsrMatrix
from tpusparse_torch.kernels.asp_spmv import AspMatrix

_KINDS = {"sell": SellMatrix, "bell": BellMatrix, "bsr": BsrMatrix,
          "awsp": AwspMatrix, "binned": BinnedSellMatrix, "asp": AspMatrix,
          "tcsr": TcsrMatrix, "rsell": RsellMatrix, "dia": DiaMatrix}


def _host(a) -> np.ndarray:
    """A leaf as a host numpy array; a bf16 tensor as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    return np.asarray(a)


def _plain(v):
    """Aux metadata as plain Python ints, floats, bools and tuples, so its
    repr parses with ``ast.literal_eval``."""
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return v


def _bsr_aux(b: BsrMatrix) -> tuple:
    return (b.shape, b.padded, b.block_m, b.nnz, b.n_real)


def _tcsr_leaves(f: TcsrMatrix):
    leaves = [f.s_bi, f.s_bj, f.idx, f.vals]
    if f.bsr is not None:
        leaves += [f.bsr.bi, f.bsr.bj, f.bsr.blocks]
    own = (f.w, f.shape, f.padded, f.nnz, f.n_sell, f.n_dense)
    return leaves, (own, None if f.bsr is None else _bsr_aux(f.bsr))


def _rsell_leaves(f: RsellMatrix):
    leaves = [f.cj, f.ct, f.idx, f.vals]
    if f.perm_plan is not None:
        leaves += [f.inv_perm, *f.perm_plan]
    return leaves, (f.shape, f.padded, f.nnz, f.n_real, f.w_max, f.run)


def _binned_leaves(f: BinnedSellMatrix):
    leaves = [a for b in f.buckets for a in (b["idx"], b["vals"])]
    return leaves + [f.inv_perm, *f.perm_plan], (f.shape, f.nnz, f.widths)


_LEAVES = {
    "sell": lambda f: ([f.idx, f.vals] + ([] if f.scales is None
                                          else [f.scales]),
                       (f.shape, f.padded, f.w, f.nnz)),
    "awsp": lambda f: ([f.idx, f.vals], (f.shape, f.padded, f.w, f.g,
                                         f.nnz)),
    "bsr": lambda f: ([f.bi, f.bj, f.blocks], _bsr_aux(f)),
    "tcsr": _tcsr_leaves,
    "dia": lambda f: ([f.vals], (f.offsets, f.shape, f.nnz, f.sym,
                                 f.xla_only)),
    "rsell": _rsell_leaves,
    # the JAX package's bitmap is uint32; the port holds the same bits as
    # int32
    "bell": lambda f: ([_host(f.bitmap).view(np.uint32), f.carries, f.vals],
                       (f.shape, f.padded, f.block_m, f.w, f.nnz)),
    "binned": _binned_leaves,
    "asp": lambda f: ([f.a_pad], (f.shape, f.block_n)),
}


def _expect(leaves: list, *counts: int) -> None:
    if len(leaves) not in counts:
        want = " or ".join(str(c) for c in counts)
        raise ValueError(f"{len(leaves)} leaves, expected {want}")


def _sell(aux, leaves) -> dict:
    _expect(leaves, 2, 3)
    shape, padded, w, nnz = aux
    return dict(kind="sell", idx=leaves[0], vals=leaves[1],
                scales=leaves[2] if len(leaves) == 3 else None, shape=shape,
                padded=padded, w=w, nnz=nnz)


def _awsp(aux, leaves) -> dict:
    _expect(leaves, 2)
    shape, padded, w, g, nnz = aux
    return dict(kind="awsp", idx=leaves[0], vals=leaves[1], shape=shape,
                padded=padded, w=w, g=g, nnz=nnz)


def _bsr_dict(aux, leaves) -> dict:
    shape, padded, block_m, nnz, n_real = aux
    return dict(kind="bsr", bi=leaves[0], bj=leaves[1], blocks=leaves[2],
                shape=shape, padded=padded, block_m=block_m, nnz=nnz,
                n_real=n_real)


def _bsr(aux, leaves) -> dict:
    _expect(leaves, 3)
    return _bsr_dict(aux, leaves)


def _tcsr(aux, leaves) -> dict:
    own, bsr_aux = aux
    _expect(leaves, 4 if bsr_aux is None else 7)
    w, shape, padded, nnz, n_sell, n_dense = own
    return dict(kind="tcsr", s_bi=leaves[0], s_bj=leaves[1], idx=leaves[2],
                vals=leaves[3], w=w, shape=shape, padded=padded, nnz=nnz,
                n_sell=n_sell, n_dense=n_dense,
                bsr=None if bsr_aux is None
                else _bsr_dict(bsr_aux, leaves[4:7]))


def _dia(aux, leaves) -> dict:
    _expect(leaves, 1)
    # 3- and 4-field aux: files saved before the sym / xla_only fields
    offsets, shape, nnz, sym, xla_only = (*aux, False, False)[:5]
    return dict(kind="dia", offsets=offsets, vals=leaves[0], shape=shape,
                nnz=nnz, sym=sym, xla_only=xla_only)


def _rsell(aux, leaves) -> dict:
    _expect(leaves, 4, 7)
    if len(aux) == 5:                  # files saved before the run field
        aux = (*aux, 1)
    shape, padded, nnz, n_real, w_max, run = aux
    d = dict(kind="rsell", cj=leaves[0], ct=leaves[1], idx=leaves[2],
             vals=leaves[3], shape=shape, padded=padded, nnz=nnz,
             n_real=n_real, w_max=w_max, run=run)
    if len(leaves) == 7:      # a sorted pack; its plan is rebuilt from it
        d["inv_perm"] = leaves[4]
    return d


def _bell(aux, leaves) -> dict:
    _expect(leaves, 3)
    shape, padded, block_m, w, nnz = aux
    return dict(kind="bell", bitmap=leaves[0], carries=leaves[1],
                vals=leaves[2], shape=shape, padded=padded, block_m=block_m,
                w=w, nnz=nnz)


def _binned(aux, leaves) -> dict:
    shape, nnz, widths = aux
    nb = len(widths)
    _expect(leaves, 2 * nb + 3)
    return dict(kind="binned", idx=leaves[0:2 * nb:2],
                vals=leaves[1:2 * nb:2], inv_perm=leaves[2 * nb],
                shape=shape, nnz=nnz, widths=widths)


def _asp(aux, leaves) -> dict:
    _expect(leaves, 1)
    shape, block_n = aux
    return dict(kind="asp", a_pad=leaves[0], shape=shape, block_n=block_n)


_REBUILD = {"sell": _sell, "awsp": _awsp, "bsr": _bsr, "tcsr": _tcsr,
            "dia": _dia, "rsell": _rsell, "bell": _bell,
            "binned": _binned, "asp": _asp}


def encode(fmt) -> tuple[str, str, str, list[np.ndarray]]:
    """``(kind, aux_repr, dtypes_repr, leaf_arrays)`` for any packed
    format, in the JAX package's layout (arrays copied to the host)."""
    kind = next((k for k, cls in _KINDS.items() if isinstance(fmt, cls)),
                None)
    if kind is None:
        raise TypeError(f"unsupported format {type(fmt).__name__}")
    leaves, aux = _LEAVES[kind](fmt)
    arrays, dtypes = [], []
    for leaf in leaves:
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        arr = _host(leaf)
        dtypes.append("bfloat16" if bf16 else str(arr.dtype))
        arrays.append(arr)
    return kind, repr(_plain(aux)), repr(dtypes), arrays


def save(path: str, fmt) -> None:
    """Persist any packed format: leaves as npz arrays, the static aux as a
    literal-parseable string."""
    kind, aux_r, dtypes_r, arrays = encode(fmt)
    np.savez_compressed(path, kind=kind, meta=np.asarray(aux_r),
                        leaf_dtypes=np.asarray(dtypes_r),
                        **{f"leaf{i}": a for i, a in enumerate(arrays)})


def decode(kind: str, aux_str: str, dtypes_str: str | None,
           arrays: list[np.ndarray], *, where: str = "<buffer>",
           device=None) -> Any:
    """Inverse of ``encode``: the port's object on ``device`` (None: the
    GPU). Shared by ``load`` and composite loaders."""
    aux = ast.literal_eval(aux_str)           # ints/tuples only
    if not isinstance(aux, (tuple, list)):
        raise ValueError(
            f"{where}: meta is {type(aux).__name__}, expected the "
            f"tree_flatten aux tuple — incompatible file; re-pack from the "
            f"source matrix")
    dtypes = ast.literal_eval(dtypes_str) if dtypes_str is not None \
        else [None] * len(arrays)
    if len(dtypes) != len(arrays):
        raise ValueError(
            f"{where}: {len(arrays)} leaves but {len(dtypes)} recorded "
            f"dtypes — file layout drifted; re-pack from the source matrix")
    # bf16 leaves stay uint16 bits: from_reference_arrays reads them so
    leaves = [arr.view(np.uint16) if dt == "bfloat16" else arr
              for arr, dt in zip(arrays, dtypes)]
    rebuild = _REBUILD.get(kind)
    if rebuild is None:
        raise ValueError(f"unknown kind {kind!r} in {where}")
    try:
        d = rebuild(tuple(aux), leaves)
    except (ValueError, TypeError) as e:
        raise ValueError(
            f"{where}: {kind} file incompatible ({e}) — saved with an "
            f"incompatible tpusparse version; re-pack from the source "
            f"matrix") from e
    return from_reference_arrays(d, device=device)


def to_device(fmt, device=None) -> Any:
    """``fmt`` rebuilt from its leaves on ``device`` (None: the GPU)."""
    kind, aux_r, dtypes_r, arrays = encode(fmt)
    return decode(kind, aux_r, dtypes_r, arrays, device=device)


def load(path: str, device=None) -> Any:
    """A pack saved by ``save`` (or by the JAX package's), on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        n_leaves = sum(1 for k in z.files
                       if k.startswith("leaf") and k != "leaf_dtypes")
        arrays = [z[f"leaf{i}"] for i in range(n_leaves)]
        dtypes = str(z["leaf_dtypes"]) if "leaf_dtypes" in z.files else None
        meta = str(z["meta"])
    return decode(kind, meta, dtypes, arrays, where=str(path), device=device)
