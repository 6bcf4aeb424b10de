"""Dense baselines: ``Y = X @ A`` with dense A.

- ``dense_torch``: the vendor baseline, counterpart of ``dense_xla``
  (``tpusparse/kernels/dense.py``): ``torch.matmul`` in true fp32 (TF32 off,
  matmul precision "highest", both set explicitly).
- ``dense_cuda`` (K2): ``csrc/dense.cu``, replacing the TPU kernel
  ``tpusparse/kernels/dense.py:_dense_kernel`` (``dense_pallas``). It
  launches the CUDA kernel for CUDA tensors and uses ``dense_plain`` only
  for CPU tensors; any other device raises.

All accept x as (m,) (SpMV) or (b, m) (SpMM); a is (m, n).
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import cdiv

# K2's launch shape (csrc/dense.cu): slices are whole 16-row stages. Blocks
# resident on an SM, by batch tile: 4 at 8 rows (the ring's registers), 6
# at 4 rows and 8 at 1-2 rows (16 KB of shared memory, their registers).
STAGE_ROWS = 16
_RESIDENT = {1: 8, 2: 8, 4: 6, 8: 4}


def batch_tile(batch: int) -> int:
    """Batch rows one block of K2 keeps in registers: 1, 2, 4 or 8."""
    return 1 if batch <= 1 else 2 if batch == 2 else 4 if batch <= 4 else 8


def dense_shape(m: int, n: int, batch: int,
                sms: int) -> tuple[int, int, int]:
    """(per_slice, slices, counters) of a K2 call: the n/128 column groups
    x the batch tiles share the card's ``sms`` x ``_RESIDENT`` block slots,
    each block a run of per_slice rows (a multiple of STAGE_ROWS); one
    arrival counter per (group, batch tile)."""
    bt = batch_tile(batch)
    groups = cdiv(n, 128) * cdiv(batch, bt)
    per, slices = _build.launch_shape(m, groups, sms * _RESIDENT[bt],
                                      quantum=STAGE_ROWS)
    return per, slices, groups


def dense_torch(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cuBLAS/CPU-BLAS baseline in full fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.matmul(x, a)


def dense_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: fp32 products summed over m."""
    squeeze = x.ndim == 1
    xb = x[None, :] if squeeze else x
    y = torch.stack([(xb[b][:, None] * a).sum(dim=0)
                     for b in range(xb.shape[0])])
    return y[0] if squeeze else y


def dense_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K2: a (m, n) fp32, x (m,) or (b, m) fp32 -> (n,) or (b, n)."""
    if x.device.type == "cpu":
        return dense_plain(a, x)
    squeeze = x.ndim == 1
    xb = x[None, :] if squeeze else x
    m, n = a.shape
    if a.dtype != torch.float32 or xb.dtype != torch.float32 \
            or xb.ndim != 2 or xb.shape[1] != m:
        raise ValueError(f"dense_cuda: a {a.dtype} {tuple(a.shape)}, "
                         f"x {x.dtype} {tuple(x.shape)}")
    dev = _build.require_cuda("dense_cuda", a, xb)
    batch = xb.shape[0]
    per_slice, slices, groups = dense_shape(m, n, batch,
                                            _build.sm_count(dev))
    part = torch.empty((slices, batch, n), dtype=torch.float32, device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    counters = _build.arrival_counters(dev, groups)
    rc = _build.lib().tps_dense_spmm(
        a.data_ptr(), xb.data_ptr(), part.data_ptr(), y.data_ptr(),
        counters.data_ptr(), m, n, batch, slices, per_slice, dev.index,
        _build.stream_of(a))
    _build.check(rc, "dense_cuda")
    dense_cuda.launches += 1
    return y[0] if squeeze else y


dense_cuda.launches = 0
