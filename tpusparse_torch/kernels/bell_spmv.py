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

The CUDA kernel decodes each column's bitmap once into a list of its live
positions and then multiplies only its live values, for every batch row a
block holds (up to 32); a block owns half an output group, a run of
contraction blocks (``bell_shape``) and those batch rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.trace import spanned
from tpusparse_torch.utils import cdiv

_LANES = 128
_MAX_BM = 1024            # at most 32 words a column: one per lane
_MAX_W = 1024             # values a column buffer holds
_WARPS = 8                # csrc/bell_spmv.cu kBellWarps
_RING = 3                 # kBellRing: column buffers a warp
_COLS = 64                # kBellCols: columns a block
_MAX_BB = 32              # batch rows a block
_MAX_RESIDENT = 3         # the kernel's __launch_bounds__ blocks an SM


class BellShape(NamedTuple):
    """A K12 call's launch: ``bb`` batch rows a block (``nz`` blocks down
    the batch), ``per_slice`` contraction blocks a block, ``slices`` blocks
    along them, ``resident`` blocks an SM, ``smem`` bytes of shared memory a
    block and ``counters`` arrival counters (one per half group and batch
    block)."""
    bb: int
    nz: int
    per_slice: int
    slices: int
    resident: int
    smem: int
    counters: int


def _x_stride(bb: int) -> int:
    return bb if bb <= 2 or (bb // 4) % 2 == 1 else bb + 4


def bell_smem_bytes(block_m: int, w: int, bb: int, per: int) -> int:
    """Dynamic shared memory of a K12 block (``csrc/bell_spmv.cu``
    ``BellSmem``): the run's bitmap words and transposed x windows, the
    warps' rings of column values and lists of live positions, then the
    block's sums."""
    words = per * _COLS * (block_m // 32) * 4
    xs = per * block_m * _x_stride(bb) * 4
    rings = _WARPS * _RING * w * 4
    lists = _WARPS * (block_m + 4) * 2
    sums = bb * _COLS * 4
    return max(words + xs + rings + lists, sums) + sums


def _resident(smem: int) -> int:
    """Blocks of ``smem`` bytes an SM holds (each also takes 1 KB)."""
    return max(1, min(_MAX_RESIDENT, _build.SM_SMEM // (smem + 1024)))


def bell_shape(nb: int, mb: int, block_m: int, w: int, batch: int, sms: int,
               smem_limit: int = _build.SMEM_LIMIT) -> BellShape:
    """The launch of a K12 call on a card of ``sms`` SMs and ``smem_limit``
    bytes of shared memory a block: as many batch rows a block as fit (up to
    32, a power of 2); then the run of contraction blocks a block that
    takes the fewest waves of resident blocks (up to 3 an SM, as shared
    memory allows), and of those the most blocks. Raises if one batch row
    and one contraction block do not fit."""
    bb = 1
    while bb < min(batch, _MAX_BB):
        bb *= 2
    while bb > 1 and bell_smem_bytes(block_m, w, bb, 1) > smem_limit:
        bb //= 2
    need = bell_smem_bytes(block_m, w, bb, 1)
    if need > smem_limit:
        raise ValueError(f"bell_spmm: block_m {block_m} and w {w} need {need} "
                         f"bytes of shared memory, over the card's "
                         f"{smem_limit}")
    nz = cdiv(batch, bb)
    best = None
    for p in range(1, mb + 1):          # the fewest waves, then most blocks
        smem = bell_smem_bytes(block_m, w, bb, p)
        if smem > smem_limit:
            break
        res = _resident(smem)
        blocks = 2 * nb * nz * cdiv(mb, p)
        key = (cdiv(blocks, res * sms), -blocks)
        if best is None or key < best[0]:
            best = (key, p, res)
    _, per, resident = best
    slices = cdiv(mb, per)
    return BellShape(bb, nz, per, slices, resident,
                     bell_smem_bytes(block_m, w, bb, per), 2 * nb * nz)


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


@spanned("tps.launch")
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
    if not 0 < block_m <= _MAX_BM or not 0 < w <= _MAX_W or w % 4:
        raise ValueError(f"bell_spmm: block_m {block_m} (<= {_MAX_BM}) and "
                         f"w {w} (<= {_MAX_W}, a multiple of 4) out of range")
    if vals.dtype != torch.float32:
        raise ValueError(f"bell_spmm: vals must be fp32, got {vals.dtype}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] > mb * block_m:
        raise ValueError(f"bell_spmm: x must be fp32 (B, <={mb * block_m}), "
                         f"got {x.dtype} {tuple(x.shape)}")
    n = nb * _LANES if n is None else n
    if not 0 <= n <= nb * _LANES:
        raise ValueError(f"bell_spmm: n = {n} outside 0 .. {nb * _LANES}")
    dev = _build.require_cuda("bell_spmm", bitmap, vals, x,
                              aligned=(bitmap, vals))
    batch = x.shape[0]
    shape = bell_shape(nb, mb, block_m, w, batch, _build.sm_count(dev),
                       _build.smem_limit(dev))
    part = torch.empty((shape.slices, batch, nb * _LANES),
                       dtype=torch.float32, device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    counters = _build.arrival_counters(dev, shape.counters)
    rc = _build.lib().tps_bell_spmm(
        bitmap.data_ptr(), vals.data_ptr(), x.data_ptr(), part.data_ptr(),
        y.data_ptr(), counters.data_ptr(), nb, mb, block_m, w, batch,
        x.shape[1], shape.slices, shape.per_slice, n, shape.bb, dev.index,
        _build.stream_of(x))
    _build.check(rc, "bell_spmm")
    bell_spmm.launches += 1
    return y


bell_spmm.launches = 0
