"""K6: block-sparse rows (BSR) — ``csrc/bsr_spmv.cu``, replacing the TPU
kernel ``tpusparse/kernels/bsr_spmv.py:_bsr_kernel_wide`` and
``_bsr_kernel_scan`` (through ``bsr_spmm_padded``).

``y[b, bj[k]*128 + r] += sum_i x[b, bi[k]*TBm + i] * blocks[k, i, r]`` over
every stored (TBm x 128) block k. The result is ``(B, n)``: the TPU kernel's
batch padded to 8 is not part of the port, nor is its wide/scan split (a
VMEM budget) or its split-bf16 dot (every product here is an fp32 FFMA).

The blocks are one (nblk * TBm, 128) panel of rows, which the kernel
streams as K2 streams A (``csrc/bsr_spmv.cu``). The (bj, bi)-sorted panel is
cut once per pack into part-tile items of one output group
(``block_items``, sized by batch tile as K2's slices are, ``bsr_plans``): a
block of threads sums one item into a (B, 128) partial, and a second
kernel adds each group's partials in a fixed order
(``csrc/block_items.cuh``). Padding and zero blocks (bi = 0, all values 0)
add 0.

``bsr_spmm`` launches the CUDA kernel for CUDA tensors and uses
``bsr_spmm_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels import _build, block_items
from tpusparse_torch.kernels.dense import batch_tile

_LANES = 128
_SUB = 8
# By batch tile (csrc/bsr_spmv.cu, as K2's dense_shape): blocks resident an
# SM (the ring's registers at 8 rows, 16 KB of shared memory and the
# registers at 1-4) and the row quantum of an item (a ring stage at 8).
SHAPES = {1: (8, 8), 2: (8, 8), 4: (6, 8), 8: (4, 16)}


def bsr_smem_bytes(bt: int) -> int:
    """Shared memory of a K6 block (``kBsrSmem``): at 8 rows the ring of 4
    stages of 16 rows and their x, else the x rows, then the 4 warps'
    sums."""
    return 4 * (16 * _LANES + bt * 16) * 4 if bt == 8 else 4 * bt * _LANES * 4


def bsr_plans(bj: np.ndarray, nb: int, block_m: int,
              device: torch.device) -> dict[int, block_items.ItemPlan]:
    """K6's work plans of a pack, one per launch shape, on ``device``."""
    return block_items.device_plans(bj, nb, block_m, device, SHAPES)


def bsr_spmm_plain(bi: torch.Tensor, bj: torch.Tensor, blocks: torch.Tensor,
                   x: torch.Tensor, *, n_padded: int,
                   n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K6 on any device: each block's fp32 product
    ``x segment @ block``, added into its group with ``index_add_`` in fp64
    (as ``rsell_spmm_plain`` does). x (B, m) fp32; columns past m read as
    0."""
    n = n_padded if n is None else n
    batch, width = x.shape
    if width == 0:
        x, width = x.new_zeros((batch, 1)), 1
    block_m = blocks.shape[1]
    row = bi.long().view(-1, 1) * block_m + torch.arange(block_m,
                                                         device=x.device)
    ok = row < width
    row = torch.where(ok, row, 0)
    blocks = blocks.float()
    y = torch.zeros((batch, n_padded // _LANES, _LANES), dtype=torch.float64,
                    device=x.device)
    for b in range(batch):          # one row at a time bounds the temporary
        xw = (x[b][row] * ok).unsqueeze(1)                    # (nblk, 1, TBm)
        part = torch.bmm(xw, blocks).squeeze(1)               # (nblk, 128)
        y[b].index_add_(0, bj.long(), part.double())
    return y.reshape(batch, n_padded)[:, :n].float().contiguous()


def bsr_spmm(bi: torch.Tensor, bj: torch.Tensor, blocks: torch.Tensor,
             x: torch.Tensor, *, n_padded: int, n: int | None = None,
             plan: dict[int, block_items.ItemPlan] | None = None
             ) -> torch.Tensor:
    """K6: bi, bj (nblk,) int32 (bj the output group, bi the contraction
    block), blocks (nblk, TBm, 128) fp32 with TBm a multiple of 8, x (B, m)
    fp32 (columns past m read as 0) -> (B, n) fp32, n <= n_padded (default
    n_padded). ``plan``: the ``bsr_plans`` of bj, built here (with a host
    copy of bj) when None."""
    if x.device.type == "cpu":
        return bsr_spmm_plain(bi, bj, blocks, x, n_padded=n_padded, n=n)
    nblk = blocks.shape[0]
    if blocks.ndim != 3 or blocks.shape[2] != _LANES \
            or blocks.shape[1] % _SUB or blocks.shape[1] == 0 \
            or blocks.dtype != torch.float32 \
            or bi.shape != (nblk,) or bj.shape != (nblk,) \
            or bi.dtype != torch.int32 or bj.dtype != torch.int32:
        raise ValueError(f"bsr_spmm: bi {tuple(bi.shape)} {bi.dtype}, bj "
                         f"{tuple(bj.shape)} {bj.dtype}, blocks "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"bsr_spmm: x must be fp32 (B, m), got {x.dtype} "
                         f"{tuple(x.shape)}")
    nb = n_padded // _LANES
    n = n_padded if n is None else n
    if n_padded % _LANES or not 0 <= n <= n_padded:
        raise ValueError(f"bsr_spmm: n={n}, n_padded={n_padded}")
    block_m = blocks.shape[1]
    block_items.check_rows("bsr_spmm", nblk, block_m)
    dev = _build.require_cuda("bsr_spmm", bi, blocks, x, aligned=(blocks,))
    batch = x.shape[0]
    bt = batch_tile(batch)
    block_items.check_smem("bsr_spmm", bsr_smem_bytes(bt),
                           _build.smem_limit(dev))
    items, gptr = block_items.resolve("bsr_spmm", plan, bj, nb, block_m, bt,
                                      dev, SHAPES)
    nitems = items.shape[0]
    if x.shape[1] == 0:             # no row of x: every product reads 0
        x = x.new_zeros((batch, 1))
    part = torch.empty((nitems, batch, _LANES), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = _build.lib().tps_bsr_spmm(
        items.data_ptr(), gptr.data_ptr(), bi.data_ptr(), blocks.data_ptr(),
        x.data_ptr(), part.data_ptr(), y.data_ptr(), nitems, block_m, batch,
        x.shape[1], n, dev.index, _build.stream_of(x))
    _build.check(rc, "bsr_spmm")
    bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0
