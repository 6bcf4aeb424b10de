"""K8: DIA SpMV — ``csrc/dia_spmv.cu``, replacing the TPU kernel
``tpusparse/kernels/dia_spmv.py:_dia_kernel`` (through
``dia_spmv_pallas``).

``y[p] = sum_i vals[i, p] * x[p + d_i]``, plus ``vals[i, p - d_i] *
x[p - d_i]`` for every ``d_i > 0`` when ``sym`` (the mirror of a bitwise-
symmetric operator stored as its ``d >= 0`` diagonals only); reads outside
``[0, n)`` are 0. One vector, a square operator.

The TPU kernel's halo strips (``xstrip_l``, ``xstrip_r``, ``vstrip``) carry
a neighbour's edge in the sharded partition and are zero on one device, so
they are not an input here; its block sizing (``_pick_rows``) is a VMEM
budget. ``halo_rows`` and ``fits`` are kept verbatim, so that ``DiaMatrix``
picks the kernel exactly where the JAX package does.

``dia_spmv`` launches the CUDA kernel for CUDA tensors and uses
``dia_spmv_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import round_up

_LANES = 128
_SUB = 8
_MAX_OFFSETS = 32          # the TPU kernel unrolls them; past this, no kernel


def halo_rows(offsets, sym: bool) -> int:
    """Halo height H_r (rows of 128) of the TPU kernel: every shifted
    window of a block, mirror reads included, stays inside [block - H_r,
    block + H_r); rounded to the f32 sublane quantum."""
    mx = max((abs(d) for d in offsets), default=0)
    if sym:
        mx = max(mx, max((d for d in offsets if d > 0), default=0))
    return round_up(mx // _LANES + 1, _SUB)


def fits(offsets, sym: bool, n: int) -> bool:
    """True where the JAX package runs its kernel: 1 to 32 diagonals, a halo
    within one block's reach, and at least one full block of rows."""
    k = len(offsets)
    if not 0 < k <= _MAX_OFFSETS:
        return False
    return halo_rows(offsets, sym) <= 512 and n >= _LANES * _SUB


def dia_spmv_plain(offsets, vals: torch.Tensor, x: torch.Tensor, *,
                   sym: bool, n: int) -> torch.Tensor:
    """Plain PyTorch version of K8 on any device: for each position p, the
    same fp32 products added in the kernel's order (diagonal i, then its
    mirror), reads outside [0, n) masked to 0. vals (k, >= n), x (n,)."""
    p = torch.arange(n, device=x.device)
    acc = torch.zeros(n, dtype=torch.float32, device=x.device)
    for i, d in enumerate(offsets):
        v = vals[i, :n].float()
        q = p + d
        ok = (q >= 0) & (q < n)
        acc = acc + v * torch.where(ok, x[q.clamp(0, max(n - 1, 0))], 0.0)
        if sym and d > 0:
            r = p - d
            okr = r >= 0
            rc = r.clamp(min=0)
            acc = acc + torch.where(okr, vals[i, rc].float() * x[rc], 0.0)
    return acc


def dia_spmv(offsets, vals: torch.Tensor, x: torch.Tensor, *, sym: bool,
             n: int) -> torch.Tensor:
    """K8: offsets (k static ints, 0 < k <= 32), vals (k, >= n) fp32, x (n,)
    fp32 -> y (n,) fp32."""
    if x.device.type == "cpu":
        return dia_spmv_plain(offsets, vals, x, sym=sym, n=n)
    k = len(offsets)
    if not 0 < k <= _MAX_OFFSETS:
        raise ValueError(f"dia_spmv: {k} diagonals, the kernel takes 1 to "
                         f"{_MAX_OFFSETS}")
    if vals.dtype != torch.float32 or vals.ndim != 2 or vals.shape[0] != k \
            or vals.shape[1] < n:
        raise ValueError(f"dia_spmv: vals must be fp32 ({k}, >= {n}), got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if x.dtype != torch.float32 or x.shape != (n,):
        raise ValueError(f"dia_spmv: x must be fp32 ({n},), got {x.dtype} "
                         f"{tuple(x.shape)}")
    dev = _build.require_cuda("dia_spmv", vals, x)
    offs = (ctypes.c_int32 * k)(*(int(d) for d in offsets))
    y = torch.empty(n, dtype=torch.float32, device=dev)
    rc = _build.lib().tps_dia_spmv(
        ctypes.addressof(offs), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
        k, int(bool(sym)), n, vals.shape[1], dev.index, _build.stream_of(x))
    _build.check(rc, "dia_spmv")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0
