"""K10: SELL value gradient — ``csrc/sell_grad.cu``, replacing the TPU
kernel ``tpusparse/kernels/sell_grad.py:_dvals_kernel`` (through
``sell_dvals_padded``).

For ``y = x @ A`` with A SELL-packed, the cotangent of each stored value is

    dvals[j,t,s,r] = sum_b x[b, t*128 + idx[j,t,s,r]] * g[b, j*128 + r]

with ``g = dL/dy``, and exactly 0 on a pad slot, which the signed planes
mark with ``idx == -1`` (``autodiff._TwinPack``; a pack's own ``idx``
points its pads at offset 0 and must never be fed here). x is (B, <= nt*128)
and g (B, <= nb*128): columns past either width read as 0, so no caller
pads them. The TPU's ``windows_per_step`` / ``col_groups_per_step`` and its
VMEM shrink loop size Pallas grid steps and are not ported.

``sell_dvals`` launches the CUDA kernel for CUDA tensors and uses
``sell_dvals_plain`` only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import _build

_LANES = 128


def sell_dvals_plain(idx_signed: torch.Tensor, x: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10 on any device. The sum runs over b in
    order, a separate multiply and add per step, as the TPU body does
    (``sell_grad.py:43-48``) and the kernel does."""
    nb, nt = idx_signed.shape[0], idx_signed.shape[1]
    x = torch.nn.functional.pad(x, (0, nt * _LANES - x.shape[1]))
    g = torch.nn.functional.pad(g, (0, nb * _LANES - g.shape[1]))
    # column of x each slot gathers: t*128 + idx (pads clamped to offset 0)
    col = (torch.arange(nt, device=x.device) * _LANES).view(1, nt, 1, 1) \
        + idx_signed.long().clamp(min=0)
    gv = g.view(g.shape[0], nb, 1, 1, _LANES)
    acc = torch.zeros(idx_signed.shape, dtype=torch.float32, device=x.device)
    for b in range(x.shape[0]):
        acc = acc + x[b][col] * gv[b]
    return torch.where(idx_signed >= 0, acc, 0.0)


def sell_dvals(idx_signed: torch.Tensor, x: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """K10: idx_signed (nb, nt, W, 128) int8 with -1 on pads, x (B, m) and
    g (B, n) fp32 with m <= nt*128 and n <= nb*128 -> dvals (nb, nt, W,
    128) fp32."""
    if x.device.type == "cpu":
        return sell_dvals_plain(idx_signed, x, g)
    if idx_signed.dtype != torch.int8 or idx_signed.ndim != 4 \
            or idx_signed.shape[3] != _LANES:
        raise ValueError(f"sell_dvals: idx_signed must be int8 (nb, nt, W, "
                         f"128), got {idx_signed.dtype} "
                         f"{tuple(idx_signed.shape)}")
    nb, nt, w, _ = idx_signed.shape
    for name, v, cap in (("x", x, nt * _LANES), ("g", g, nb * _LANES)):
        if v.dtype != torch.float32 or v.ndim != 2 or v.shape[1] > cap:
            raise ValueError(f"sell_dvals: {name} must be fp32 (B, <={cap}), "
                             f"got {v.dtype} {tuple(v.shape)}")
    if x.shape[0] != g.shape[0]:
        raise ValueError(f"sell_dvals: batch of x {x.shape[0]} != batch of g "
                         f"{g.shape[0]}")
    out = torch.empty(idx_signed.shape, dtype=torch.float32,
                      device=idx_signed.device)
    dev = _build.require_cuda("sell_dvals", idx_signed, x, g, out,
                              aligned=(idx_signed, out))
    rc = _build.lib().tps_sell_dvals(
        idx_signed.data_ptr(), x.data_ptr(), g.data_ptr(), out.data_ptr(),
        nb, nt, w, x.shape[0], x.shape[1], g.shape[1], dev.index,
        _build.stream_of(x))
    _build.check(rc, "sell_dvals")
    sell_dvals.launches += 1
    return out


sell_dvals.launches = 0
