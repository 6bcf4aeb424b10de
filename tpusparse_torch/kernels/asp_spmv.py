"""K9: activation-sparse products over dense A ("ASP") — ``csrc/asp_spmv.cu``,
replacing the TPU kernel ``tpusparse/kernels/asp_spmv.py:_asp_kernel``
(through ``_asp_pallas``, for both its static plan and its device plan).

``AspMatrix`` keeps A dense, as the JAX package does, and each product
visits only the 128-row windows of A where X has a nonzero. ``a_pad`` has
JAX's shape: rows padded to 128 plus one trailing all-zero window (id
``nt``, which an empty plan points at), columns padded to ``block_n``.
``block_n`` is carried as layout only: the CUDA kernel's launch shape comes
from ``asp_shape``. The JAX package pads the batch to 8 rows for the TPU's
sublanes; the port does not.

The kernel is one launch a call with no partial sums in device memory: a
strip of 128 output columns and a batch tile belongs to a cluster of 1-8
blocks that split the live windows' rows, stream them through a ring of
stages filled by 2D tensor copies (TMA), and add their sums through
distributed shared memory in rank order (``csrc/asp_spmv.cu``).

Plans are those of ``formats/awsp.py`` (``PlanSkip``) at window
granularity: a host plan for host data, the device plan
(``device_group_plan`` over 128-row windows, no host sync) for a CUDA
tensor or ``plan="device"``, or an explicit list of window ids.

``asp_spmm`` launches the CUDA kernel for CUDA tensors and uses
``asp_spmm_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.formats.awsp import PlanSkip
from tpusparse_torch.formats.csr import _host_numpy
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.dense import batch_tile, dense_plain
from tpusparse_torch.utils import cdiv, resolve_device, round_up

_LANES = 128
# csrc/asp_spmv.cu: rows a ring stage, stages, the mbarriers' header, and
# the blocks a cluster may hold (portable sizes)
STAGE_ROWS = 4 * 8
STAGES = 4
_HEADER = 128
CLUSTERS = (8, 4, 2, 1)


def asp_smem_bytes(bt: int) -> int:
    """Dynamic shared memory of a K9 block (``kAspSmem``): the mbarriers and
    a ring of STAGES stages of STAGE_ROWS rows of 128 columns and their x
    values for ``bt`` batch rows."""
    return _HEADER + STAGES * (STAGE_ROWS * _LANES + bt * STAGE_ROWS) * 4


def asp_shape(n: int, batch: int, sms: int) -> tuple[int, int, int]:
    """(cluster, strips, tiles) of a K9 call on a card of ``sms`` SMs:
    strips of 128 columns x batch tiles, each a cluster of blocks, the
    largest cluster for which every block has an SM to itself (1 when the
    strips alone fill the card): more blocks an SM, each streaming its own
    rows of A, measured slower on an H100 (PERF.md)."""
    strips, tiles = cdiv(n, _LANES), cdiv(batch, batch_tile(batch))
    cluster = next((c for c in CLUSTERS if strips * tiles * c <= sms), 1)
    return cluster, strips, tiles


def asp_spmm_plain(plan: torch.Tensor, k: torch.Tensor, a_pad: torch.Tensor,
                   x: torch.Tensor, *, n: int) -> torch.Tensor:
    """Plain PyTorch version of K9 on any device (no host sync either):
    the windows ``plan[:k]`` of x times the same rows of A."""
    dev = x.device
    live = torch.arange(plan.numel(), device=dev) < k.reshape(())
    rows = (plan.long()[:, None] * _LANES
            + torch.arange(_LANES, device=dev)).reshape(-1)
    xp = torch.nn.functional.pad(x, (0, a_pad.shape[0] - x.shape[1]))
    xs = xp[:, rows] * live.repeat_interleave(_LANES)
    return dense_plain(a_pad[rows][:, :n], xs)


def asp_spmm(plan: torch.Tensor, k: torch.Tensor, a_pad: torch.Tensor,
             x: torch.Tensor, *, n: int) -> torch.Tensor:
    """K9: plan (P,) int32 window ids, k (1,) int32 live count, a_pad
    (rows, Np) fp32 with the zero window last, x (B, m) fp32 with
    m <= rows (the kernel reads missing columns as 0) -> (B, n) fp32."""
    if x.device.type == "cpu":
        return asp_spmm_plain(plan, k, a_pad, x, n=n)
    rows, lda = a_pad.shape
    if a_pad.dtype != torch.float32 or rows % _LANES or not 0 < n <= lda:
        raise ValueError(f"asp_spmm: a_pad {a_pad.dtype} {tuple(a_pad.shape)}"
                         f", n={n}")
    if plan.dtype != torch.int32 or k.dtype != torch.int32 or k.numel() != 1:
        raise ValueError("asp_spmm: plan and k must be int32, k of size 1")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] > rows:
        raise ValueError(f"asp_spmm: x must be fp32 (B, <={rows}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    dev = _build.require_cuda("asp_spmm", plan, k, a_pad, x)
    batch, plan_len = x.shape[0], plan.numel()
    cluster, _, _ = asp_shape(n, batch, _build.sm_count(dev))
    if x.shape[1] == 0:             # no row of x: every product reads 0
        x = x.new_zeros((batch, 1))
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = _build.lib().tps_asp_spmm(
        plan.data_ptr(), k.data_ptr(), a_pad.data_ptr(), x.data_ptr(),
        y.data_ptr(), rows, lda, n, batch, x.shape[1], plan_len, cluster,
        dev.index, _build.stream_of(x))
    _build.check(rc, "asp_spmm")
    asp_spmm.launches += 1
    return y


asp_spmm.launches = 0


class AspMatrix(PlanSkip):
    """Dense A prepared for window-skip activation-sparse products."""

    def __init__(self, a_pad: torch.Tensor, shape, block_n: int):
        self.a_pad = a_pad            # (Mp + 128, Np): trailing zero window
        self.shape = tuple(shape)
        self.block_n = block_n
        self._counts: dict[int, torch.Tensor] = {}   # plan length -> count
        self._full: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.a_pad.device

    def __repr__(self) -> str:
        return (f"AspMatrix(shape={self.shape}, block_n={self.block_n}, "
                f"device={self.device}, dense {self.device_bytes() / 1e6:.1f}"
                f" MB + window-skip plans)")

    @classmethod
    def from_dense(cls, a, block_n: int = 2048, device=None) -> "AspMatrix":
        """Dense A (numpy or tensor) on ``device`` (None: the GPU)."""
        dev = resolve_device(device)
        a = _host_numpy(a)
        m, n = a.shape
        mp, np_ = round_up(m, _LANES), round_up(n, block_n)
        a_pad = np.zeros((mp + _LANES, np_), a.dtype)   # extra zero window
        a_pad[:m, :n] = a
        return cls(torch.from_numpy(a_pad).to(dev), (m, n), block_n)

    @classmethod
    def from_csr(cls, csr, block_n: int = 2048, device=None) -> "AspMatrix":
        """ASP's format IS a padded dense array, so this materializes
        (m, n) memory; it lets ``auto_format`` route CSR input here."""
        resolve_device(device)
        return cls.from_dense(csr.to_dense(), block_n=block_n, device=device)

    @property
    def n_units(self) -> int:
        """Real 128-row windows (the zero window is id ``n_units``)."""
        return self.a_pad.shape[0] // _LANES - 1

    span = _LANES

    def device_bytes(self) -> int:
        return self.a_pad.numel() * self.a_pad.element_size()

    def to_dense(self) -> torch.Tensor:
        return self.a_pad[:self.shape[0], :self.shape[1]].cpu()

    def plan(self, x) -> np.ndarray:
        """Active-window ids for this activation (the zero window if none).
        ``x``: numpy or a tensor (fetched to the host)."""
        x = _host_numpy(x)
        m = self.shape[0]
        nt = self.n_units
        xw = np.zeros(nt * _LANES, dtype=bool)
        flat = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x[None, :]
        xw[:m] = (flat != 0).any(axis=0)
        active = np.nonzero(xw.reshape(nt, _LANES).any(axis=1))[0]
        if active.size == 0:
            active = np.array([nt])                     # only the zero window
        return active.astype(np.int32)

    def _product(self, xt: torch.Tensor, plan: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
        return asp_spmm(plan, k, self.a_pad, xt, n=self.shape[1])
