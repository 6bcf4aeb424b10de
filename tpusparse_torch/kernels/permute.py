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

Bound: bytes — y, ``src`` and the output each touched once (96 KB at
B = 1, n = 8192), far below the launch latency, so a call's time is its
launch. ``permute_columns`` launches the CUDA kernel for CUDA tensors and
uses ``permute_columns_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import round_up

_LANES = 128
_HB = 8          # the JAX plan pads the output groups to a multiple of 8


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


def permute_columns_plain(y: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5 on any device: y (B, ldy), src (n,) int32
    -> (B, n). Sources outside [0, ldy) read 0, as in the kernel."""
    ok = (src >= 0) & (src < y.shape[1])
    out = y[:, torch.where(ok, src, 0).long()]
    return out.masked_fill_(~ok, 0.0)


def permute_columns(y: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """K5: y (B, ldy) fp32, src (n,) int32 source lanes (-1: dead) ->
    (B, n) fp32."""
    if y.device.type == "cpu":
        return permute_columns_plain(y, src)
    if y.dtype != torch.float32 or y.ndim != 2 or src.dtype != torch.int32 \
            or src.ndim != 1:
        raise ValueError(f"permute_columns: y {y.dtype} {tuple(y.shape)}, "
                         f"src {src.dtype} {tuple(src.shape)}")
    dev = _build.require_cuda("permute_columns", y, src)
    batch, n = y.shape[0], src.numel()
    out = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = _build.lib().tps_permute_columns(
        y.data_ptr(), src.data_ptr(), out.data_ptr(), batch, y.shape[1], n,
        dev.index, _build.stream_of(y))
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
