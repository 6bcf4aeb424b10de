"""K11: SELL SpMM by decompress-to-dense — ``csrc/sell_mxu_spmm.cu``,
replacing the TPU study kernel
``tpusparse/kernels/sell_mxu_spmm.py:_mxu_kernel`` (through
``sell_mxu_spmm_padded``).

For each SELL tile (j, t) it scatter-ADDS the W x 128 slots into a dense
128 x 128 tile, ``dense[idx[s, r], r] += vals[s, r]`` (pad slots carry
index 0 and value 0 and alias a real offset-0 entry, so a store would lose
it), then ``y[:, j-group] += x[:, t-window] @ dense`` for every batch row.
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

_LANES = 128


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
    if vals.dtype != torch.float32:
        raise ValueError(f"sell_mxu_spmm: vals must be fp32, got {vals.dtype}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] > nt * _LANES:
        raise ValueError(f"sell_mxu_spmm: x must be fp32 (B, <={nt * _LANES}),"
                         f" got {x.dtype} {tuple(x.shape)}")
    dev = _build.require_cuda("sell_mxu_spmm", idx, vals, x)
    n = nb * _LANES if n is None else n
    batch = x.shape[0]
    per_slice, slices = _build.split_work(nt, nb, dev)
    part = torch.empty((slices, batch, nb * _LANES), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = _build.lib().tps_sell_mxu_spmm(
        idx.data_ptr(), vals.data_ptr(), x.data_ptr(), part.data_ptr(),
        y.data_ptr(), nb, nt, w, batch, x.shape[1], slices, per_slice, n,
        dev.index, _build.stream_of(x))
    _build.check(rc, "sell_mxu_spmm")
    sell_mxu_spmm.launches += 1
    return y


sell_mxu_spmm.launches = 0
