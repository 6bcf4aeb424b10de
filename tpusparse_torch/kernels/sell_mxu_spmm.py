"""K11: SELL SpMM by decompress-to-dense — ``csrc/sell_mxu_spmm.cu``,
replacing the TPU study kernel
``tpusparse/kernels/sell_mxu_spmm.py:_mxu_kernel`` (through
``sell_mxu_spmm_padded``).

For each SELL tile (j, t) it builds a dense 128 x 128 tile,
``dense[idx[s, r], r] += vals[s, r]``, then
``y[:, j-group] += x[:, t-window] @ dense`` for every batch row. The plain
version adds (pad slots carry index 0 and value 0 and alias a real
offset-0 entry, so an unconditional store would lose it); the CUDA kernel
stores every slot whose value is not 0, which gives the same tile bit for
bit, and multiplies on the tensor cores in 3xTF32 (the kernel's note).
It runs on a ``SellMatrix``'s ``idx``/``vals`` and has no format of its
own: a study kernel, measured beside K1 by the floors study
(``bench/report.py``), not a routing default. The result is ``(B, n)``:
the TPU kernel's ``(B8, N_pad)`` slab is not part of the port.

``sell_mxu_spmm`` launches the CUDA kernel for CUDA tensors and uses
``sell_mxu_spmm_plain`` only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import cdiv

_LANES = 128
# Blocks of the CUDA kernel resident on one SM: its dense tile (66 KB), x
# tiles and ring of tile slabs take most of the SM's shared memory.
_RESIDENT = 1


def batch_tile(batch: int) -> int:
    """Batch rows one block of the CUDA kernel covers: 8, 16 or 32."""
    return 8 if batch <= 8 else 16 if batch <= 16 else 32


def mxu_shape(nb: int, nt: int, batch: int, sms: int) -> tuple[int, int, int]:
    """(per_slice, slices, counters) of a K11 call: nb column groups x the
    batch tiles share the card's ``sms`` x ``_RESIDENT`` block slots, and
    each block walks a run of per_slice windows; one arrival counter per
    (group, batch tile)."""
    groups = nb * cdiv(batch, batch_tile(batch))
    per, slices = _build.launch_shape(nt, groups, sms * _RESIDENT)
    return per, slices, groups


def sell_mxu_spmm_plain(idx: torch.Tensor, vals: torch.Tensor,
                        x: torch.Tensor, *,
                        n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K11 on any device: the dense tiles by an
    additive scatter, then one product per output group. idx/vals
    (nb, nt, W, 128), x (B, m) fp32 with m <= nt*128 -> (B, n)."""
    nb, nt, w, _ = vals.shape
    n = nb * _LANES if n is None else n
    x = torch.nn.functional.pad(x, (0, nt * _LANES - x.shape[1]))
    xw = x.reshape(x.shape[0], nt, _LANES)
    lane = torch.arange(_LANES, device=x.device)
    y = torch.empty((x.shape[0], nb * _LANES), dtype=torch.float32,
                    device=x.device)
    for j in range(nb):             # one output group at a time
        flat = (idx[j].long() * _LANES + lane).reshape(nt, w * _LANES)
        dense = torch.zeros((nt, _LANES * _LANES), dtype=torch.float32,
                            device=x.device)
        dense.scatter_add_(1, flat, vals[j].float().reshape(nt, w * _LANES))
        y[:, j * _LANES:(j + 1) * _LANES] = torch.einsum(
            "btc,tcr->br", xw, dense.view(nt, _LANES, _LANES))
    return y[:, :n].contiguous()


def sell_mxu_spmm(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
                  n: int | None = None) -> torch.Tensor:
    """K11: idx (nb, nt, W, 128) int8, vals the same shape fp32, x (B, m)
    fp32 with m <= nt*128 (the kernel reads missing columns as 0) ->
    (B, n) fp32."""
    if x.device.type == "cpu":
        return sell_mxu_spmm_plain(idx, vals, x, n=n)
    nb, nt, w, lanes = vals.shape
    if idx.shape != vals.shape or idx.dtype != torch.int8 or lanes != _LANES:
        raise ValueError(f"sell_mxu_spmm: idx {tuple(idx.shape)} {idx.dtype} "
                         f"vs vals {tuple(vals.shape)}")
    if w % 8:
        raise ValueError(f"sell_mxu_spmm: W = {w} is not a multiple of 8 "
                         "(the packers round it up)")
    if vals.dtype != torch.float32:
        raise ValueError(f"sell_mxu_spmm: vals must be fp32, got {vals.dtype}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] > nt * _LANES:
        raise ValueError(f"sell_mxu_spmm: x must be fp32 (B, <={nt * _LANES}),"
                         f" got {x.dtype} {tuple(x.shape)}")
    # the kernel fetches each tile's slabs with bulk copies: 16-byte aligned
    dev = _build.require_cuda("sell_mxu_spmm", idx, vals, x,
                              aligned=(idx, vals))
    n = nb * _LANES if n is None else n
    batch = x.shape[0]
    per_slice, slices, groups = mxu_shape(nb, nt, batch,
                                          _build.sm_count(dev))
    part = torch.empty((slices, batch, nb * _LANES), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    counters = _build.arrival_counters(dev, groups)
    rc = _build.lib().tps_sell_mxu_spmm(
        idx.data_ptr(), vals.data_ptr(), x.data_ptr(), part.data_ptr(),
        y.data_ptr(), counters.data_ptr(), nb, nt, w, batch, x.shape[1],
        slices, per_slice, n, dev.index, _build.stream_of(x))
    _build.check(rc, "sell_mxu_spmm")
    sell_mxu_spmm.launches += 1
    return y


sell_mxu_spmm.launches = 0
