"""K5: static column permutation — ``csrc/permute.cu``, replacing the TPU
kernel ``tpusparse/kernels/permute.py:_permute_kernel`` (through
``permute_columns`` and ``apply_permutation``).

``out[b, p] = y[b, src[p]]`` for p < n, and 0 where ``src[p] < 0`` (a dead
lane). The plan keeps the JAX package's arrays bit for bit
(``permute_plan``: ``oidx``, each output lane's in-group source offset, and
``oh``, one-hot source-group masks, O(n²/128) fp32), so packs compare. The
TPU needed the one-hot form because XLA's lane gather is near-serial there;
on the card a gather is one load a thread, so ``source_lanes`` turns
(oidx, oh) into one int32 source lane per output lane, once, when a pack is
built, and the kernel reads only that.

``y`` may be a list of up to three parts read as their concatenation
along the columns: binned SELL hands K5 its buckets' K1 outputs as they
are, with no ``torch.cat`` between. A column-sorted RSELL pack launches no
K5: K4's second kernel writes through the inverse of the same source lanes
(``kernels/rsell_spmv.py:Unpermute``).

Bound: bytes — y, ``src`` and the output each touched once (96 KB at
B = 1, n = 8192), far below the launch latency, so a call's time is its
launch. ``permute_columns`` launches the CUDA kernel for CUDA tensors and
uses ``permute_columns_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.trace import spanned
from tpusparse_torch.utils import round_up

_LANES = 128
_HB = 8          # the JAX plan pads the output groups to a multiple of 8
MAX_PARTS = 3    # csrc/permute.cu kPermuteParts: binned SELL's buckets at most


def permute_plan(perm_src: np.ndarray, src_size: int | None = None) -> dict:
    """Pack a static permutation: output lane p sources input lane
    ``perm_src[p]``. Returns oidx/oh padded to a multiple of 8 groups
    (padding maps to input lane 0 with a zero mask -> zero output).
    ``src_size``: source lane-space size when it differs from the output
    size (a selecting gather, not a square permutation)."""
    n = perm_src.size
    np_ = round_up(n, _LANES)
    src = np.zeros(np_, dtype=np.int64)
    src[:n] = perm_src
    nb_out = np_ // _LANES
    nb = round_up(src_size, _LANES) // _LANES if src_size else nb_out
    nbp = round_up(nb_out, _HB)
    g = src // _LANES                        # source group per output lane
    o = src % _LANES
    oidx = np.zeros((nbp, _LANES), np.int8)
    oidx[:nb_out] = o.reshape(nb_out, _LANES).astype(np.int8)
    oh = np.zeros((nbp, nb, _LANES), np.float32)
    hh = np.repeat(np.arange(nb_out), _LANES)
    cc = np.tile(np.arange(_LANES), nb_out)
    oh[hh, g, cc] = 1.0
    if n < np_:                              # padded output lanes -> 0
        dead = np.arange(n, np_)
        oh[dead // _LANES, :, dead % _LANES] = 0.0
    return dict(oidx=oidx, oh=oh, n=n, np_=np_, nb=nb)


def source_lanes(oidx: np.ndarray, oh: np.ndarray, n: int) -> np.ndarray:
    """(n,) int32: the input lane each of the first n output lanes of the
    plan ``(oidx, oh)`` reads, -1 where its mask is all zero."""
    oh = np.asarray(oh)
    live = oh.any(axis=1)                            # (nbp, 128)
    src = oh.argmax(axis=1) * _LANES + np.asarray(oidx).astype(np.int64)
    return np.where(live, src, -1).reshape(-1)[:n].astype(np.int32)


def permute_columns_plain(y, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5 on any device: y (B, ldy), or a list of
    up to ``MAX_PARTS`` (B, ld_k) parts standing for their concatenation
    along the columns, src (n,) int32 -> (B, n). Sources outside the lanes
    of y read 0, as in the kernel. With parts, each part's lanes are
    gathered from it in place."""
    if isinstance(y, torch.Tensor):
        ok = (src >= 0) & (src < y.shape[1])
        out = y[:, torch.where(ok, src, 0).long()]
        return out.masked_fill_(~ok, 0.0)
    out = y[0].new_zeros((y[0].shape[0], src.numel()))
    lo = 0
    for part in y:
        hit = (src >= lo) & (src < lo + part.shape[1])
        out[:, hit] = part[:, (src[hit] - lo).long()]
        lo += part.shape[1]
    return out


@spanned("tps.launch")
def permute_columns(y, src: torch.Tensor) -> torch.Tensor:
    """K5: y (B, ldy) fp32, or a list of up to ``MAX_PARTS`` (B, ld_k) fp32
    parts read as their concatenation along the columns (never joined in
    memory), src (n,) int32 source lanes (-1: dead) -> (B, n) fp32."""
    parts = [y] if isinstance(y, torch.Tensor) else list(y)
    if not 0 < len(parts) <= MAX_PARTS:
        raise ValueError(f"permute_columns: {len(parts)} parts, want 1 to "
                         f"{MAX_PARTS}")
    if parts[0].device.type == "cpu":
        return permute_columns_plain(y, src)
    batch = parts[0].shape[0]
    if any(p.dtype != torch.float32 or p.ndim != 2 or p.shape[0] != batch
           for p in parts) or src.dtype != torch.int32 or src.ndim != 1:
        shapes = [(p.dtype, tuple(p.shape)) for p in parts]
        raise ValueError(f"permute_columns: y {shapes}, src {src.dtype} "
                         f"{tuple(src.shape)}")
    dev = _build.require_cuda("permute_columns", *parts, src)
    n = src.numel()
    out = torch.empty((batch, n), dtype=torch.float32, device=dev)
    ptrs = [p.data_ptr() for p in parts] + [None] * (MAX_PARTS - len(parts))
    lds = [p.shape[1] for p in parts] + [0] * (MAX_PARTS - len(parts))
    rc = _build.lib().tps_permute_columns(
        *ptrs, src.data_ptr(), out.data_ptr(), *lds, batch, n, dev.index,
        _build.stream_of(parts[0]))
    _build.check(rc, "permute_columns")
    permute_columns.launches += 1
    return out


permute_columns.launches = 0


def apply_permutation(y2d: torch.Tensor, plan_arrays: tuple,
                      n: int) -> torch.Tensor:
    """y2d (B, np_) -> (B, n) permuted by the JAX-layout plan
    ``(oidx, oh)``; callers that permute often keep ``source_lanes``."""
    oidx, oh = plan_arrays
    src = torch.from_numpy(source_lanes(oidx, oh, n)).to(y2d.device)
    return permute_columns(y2d, src)
