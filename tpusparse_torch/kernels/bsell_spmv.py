"""K7: block-SELL tiles, the SELL tier of TCSR — ``csrc/bsell_spmv.cu``,
replacing the TPU kernel ``tpusparse/kernels/bsell_spmv.py:
_bsell_kernel_wide`` and ``_bsell_kernel_scan`` (tile body
``_tile_product``, through ``bsell_spmm_padded``).

``y[b, bj[k]*128 + r] += sum_s vals[k, s, r] * x[b, bi[k]*128 + idx[k, s, r]]``
over every (W x 128) tile k. The result is ``(B, n)``: the TPU kernel's
``(B*8, N)`` slab (row b*8 holding y_b) and its ones-matrix MXU reduction
are not part of the port. The tiles are one stream of W-slot rows, cut
once per pack into part-tile items of one output group, each within
``MAX_TILES`` tiles (``block_items``, ``bsell_plans``): a block stages the
item's x windows once and streams its slot rows (``csrc/bsell_spmv.cu``),
and a second kernel adds each group's partials in a fixed order, as K6's.
Zero tiles (idx 0, vals 0) add 0.

``bsell_spmm`` launches the CUDA kernel for CUDA tensors and uses
``bsell_spmm_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels import _build, block_items
from tpusparse_torch.kernels.dense import batch_tile
from tpusparse_torch.trace import spanned

_LANES = 128
# csrc/bsell_spmv.cu kMaxWin: the x windows a block stages for its item
MAX_TILES = 4
# By batch tile: blocks resident an SM (the kernel's __launch_bounds__) and
# the slot-row quantum of an item (one row a warp).
SHAPES = {1: (8, 4), 2: (8, 4), 4: (6, 4), 8: (8, 4)}


def bsell_smem_bytes(bt: int) -> int:
    """Shared memory of a K7 block (``kBsellSmem``): the item's x windows,
    then the 4 warps' sums."""
    return max(MAX_TILES, 4) * bt * _LANES * 4


def bsell_plans(bj: np.ndarray, nb: int, w: int,
                device: torch.device) -> dict[int, block_items.ItemPlan]:
    """K7's work plans of a pack, one per launch shape, on ``device``."""
    return block_items.device_plans(bj, nb, w, device, SHAPES, MAX_TILES)


def bsell_spmm_plain(bi: torch.Tensor, bj: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor, x: torch.Tensor, *, n_padded: int,
                     n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K7 on any device: the same fp32 products,
    each tile's W slots summed, then added into its group with
    ``index_add_`` in fp64. x (B, m) fp32; columns past m read as 0."""
    n = n_padded if n is None else n
    batch, width = x.shape
    if width == 0:
        x, width = x.new_zeros((batch, 1)), 1
    col = bi.long().view(-1, 1, 1) * _LANES + idx.long()
    ok = col < width
    col = torch.where(ok, col, 0)
    v = vals.float() * ok
    y = torch.zeros((batch, n_padded // _LANES, _LANES), dtype=torch.float64,
                    device=x.device)
    for b in range(batch):          # one row at a time bounds the temporary
        y[b].index_add_(0, bj.long(), (v * x[b][col]).sum(dim=1).double())
    return y.reshape(batch, n_padded)[:, :n].float().contiguous()


@spanned("tps.launch")
def bsell_spmm(bi: torch.Tensor, bj: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor, x: torch.Tensor, *, n_padded: int,
               n: int | None = None,
               plan: dict[int, block_items.ItemPlan] | None = None
               ) -> torch.Tensor:
    """K7: bi, bj (nblk,) int32 (bj the output group, bi the contraction
    window), idx (nblk, W, 128) int8, vals (nblk, W, 128) fp32, x (B, m)
    fp32 (columns past m read as 0) -> (B, n) fp32, n <= n_padded (default
    n_padded). ``plan``: the ``bsell_plans`` of bj, built here (with a host
    copy of bj) when None."""
    if x.device.type == "cpu":
        return bsell_spmm_plain(bi, bj, idx, vals, x, n_padded=n_padded, n=n)
    nblk = vals.shape[0]
    if vals.ndim != 3 or vals.shape[2] != _LANES or idx.shape != vals.shape \
            or vals.shape[1] == 0 \
            or idx.dtype != torch.int8 or vals.dtype != torch.float32 \
            or bi.shape != (nblk,) or bj.shape != (nblk,) \
            or bi.dtype != torch.int32 or bj.dtype != torch.int32:
        raise ValueError(f"bsell_spmm: bi {tuple(bi.shape)} {bi.dtype}, bj "
                         f"{tuple(bj.shape)} {bj.dtype}, idx "
                         f"{tuple(idx.shape)} {idx.dtype}, vals "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"bsell_spmm: x must be fp32 (B, m), got {x.dtype} "
                         f"{tuple(x.shape)}")
    nb = n_padded // _LANES
    n = n_padded if n is None else n
    if n_padded % _LANES or not 0 <= n <= n_padded:
        raise ValueError(f"bsell_spmm: n={n}, n_padded={n_padded}")
    w = vals.shape[1]
    block_items.check_rows("bsell_spmm", nblk, w)
    dev = _build.require_cuda("bsell_spmm", bi, idx, vals, x,
                              aligned=(idx, vals))
    batch = x.shape[0]
    bt = batch_tile(batch)
    block_items.check_smem("bsell_spmm", bsell_smem_bytes(bt),
                           _build.smem_limit(dev))
    items, gptr = block_items.resolve("bsell_spmm", plan, bj, nb, w, bt, dev,
                                      SHAPES, MAX_TILES)
    nitems = items.shape[0]
    if x.shape[1] == 0:             # no row of x: every product reads 0
        x = x.new_zeros((batch, 1))
    part = torch.empty((nitems, batch, _LANES), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = _build.lib().tps_bsell_spmm(
        items.data_ptr(), gptr.data_ptr(), bi.data_ptr(), idx.data_ptr(),
        vals.data_ptr(), x.data_ptr(), part.data_ptr(), y.data_ptr(), nitems,
        w, batch, x.shape[1], n, dev.index, _build.stream_of(x))
    _build.check(rc, "bsell_spmm")
    bsell_spmm.launches += 1
    return y


bsell_spmm.launches = 0
