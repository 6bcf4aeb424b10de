"""K12: bitmap blocked-ELL SpMV/SpMM — ``csrc/bell_spmv.cu``, replacing the
TPU kernel ``tpusparse/kernels/bell_spmv.py:_bell_kernel`` (through
``bell_spmm_padded``).

``y[b, j*128 + r] = sum_i sum_l A[i*BM + l, j*128 + r] * x[b, i*BM + l]``
where column r of tile (j, i) holds a nonzero at position l iff its bit is
set (word ``l % nwords``, bit ``l // nwords``), and that nonzero's value is
``vals[j, i, r, rank]``, rank being the number of set positions before l.
The result is ``(B, n)``: the TPU kernel's transposed ``(N_pad, B8)`` slab
is not part of the port. Neither version reads the carries: the CUDA
kernel ranks a whole column in one warp, the plain version with a cumsum.

``bell_spmm`` launches the CUDA kernel for CUDA tensors and uses
``bell_spmm_plain`` only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import _build

_LANES = 128
_COLS_PER_BLOCK = 64      # csrc/bell_spmv.cu kBellCols
_MAX_BM = 1024            # at most 32 words a column: one per lane
_MAX_W = 1024             # the kernel's per-lane prefetch holds 8 float4


def expand_mask(bitmap: torch.Tensor, block_m: int) -> torch.Tensor:
    """(..., BM/32) int32 words -> (..., BM) bool, position l from word
    l % nwords, bit l // nwords."""
    nwords = block_m // 32
    pos = torch.arange(block_m, device=bitmap.device)
    words = bitmap[..., pos % nwords]
    return ((words >> (pos // nwords).to(torch.int32)) & 1).bool()


def bell_spmm_plain(bitmap: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    *, block_m: int, n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K12 on any device: bitmap (nb, mb, 128,
    BM/32) int32, vals (nb, mb, 128, W), x (B, m) fp32 with m <= mb*BM
    -> (B, n)."""
    nb, mb, _, w = vals.shape
    n = nb * _LANES if n is None else n
    x = torch.nn.functional.pad(x, (0, mb * block_m - x.shape[1]))
    xb = x.reshape(x.shape[0], mb, block_m)
    y = torch.empty((x.shape[0], nb * _LANES), dtype=torch.float32,
                    device=x.device)
    for j in range(nb):             # one output group at a time
        mask = expand_mask(bitmap[j], block_m)           # (mb, 128, BM)
        rank = torch.cumsum(mask, dim=-1) - mask.long()
        dense = torch.where(mask, torch.gather(vals[j].float(), -1,
                                               rank.clamp_(max=w - 1)), 0.0)
        y[:, j * _LANES:(j + 1) * _LANES] = torch.einsum("bil,irl->br", xb,
                                                         dense)
    return y[:, :n].contiguous()


def bell_spmm(bitmap: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
              block_m: int, n: int | None = None) -> torch.Tensor:
    """K12: bitmap (nb, mb, 128, BM/32) int32, vals (nb, mb, 128, W) fp32,
    x (B, m) fp32 with m <= mb*BM (the kernel reads missing columns as 0)
    -> (B, n) fp32."""
    if x.device.type == "cpu":
        return bell_spmm_plain(bitmap, vals, x, block_m=block_m, n=n)
    nb, mb, lanes, w = vals.shape
    if bitmap.shape != (nb, mb, lanes, block_m // 32) or lanes != _LANES \
            or bitmap.dtype != torch.int32 or block_m % 32:
        raise ValueError(f"bell_spmm: bitmap {tuple(bitmap.shape)} "
                         f"{bitmap.dtype} vs vals {tuple(vals.shape)}, "
                         f"block_m {block_m}")
    if block_m > _MAX_BM or w > _MAX_W or w % 4:
        raise ValueError(f"bell_spmm: block_m {block_m} (<= {_MAX_BM}) and "
                         f"w {w} (<= {_MAX_W}, a multiple of 4) out of range")
    if vals.dtype != torch.float32:
        raise ValueError(f"bell_spmm: vals must be fp32, got {vals.dtype}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] > mb * block_m:
        raise ValueError(f"bell_spmm: x must be fp32 (B, <={mb * block_m}), "
                         f"got {x.dtype} {tuple(x.shape)}")
    dev = _build.require_cuda("bell_spmm", bitmap, vals, x, aligned=(vals,))
    n = nb * _LANES if n is None else n
    batch = x.shape[0]
    per_slice, slices = _build.split_work(
        mb, nb * (_LANES // _COLS_PER_BLOCK), dev)
    part = torch.empty((slices, batch, nb * _LANES), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = _build.lib().tps_bell_spmm(
        bitmap.data_ptr(), vals.data_ptr(), x.data_ptr(), part.data_ptr(),
        y.data_ptr(), nb, mb, block_m, w, batch, x.shape[1], slices,
        per_slice, n, dev.index, _build.stream_of(x))
    _build.check(rc, "bell_spmm")
    bell_spmm.launches += 1
    return y


bell_spmm.launches = 0
