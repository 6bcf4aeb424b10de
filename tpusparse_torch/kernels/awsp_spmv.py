"""K3: AWSP — SELL restricted to the active window groups of a plan.

``csrc/awsp_spmv.cu``, replacing the TPU kernel
``tpusparse/kernels/awsp_spmv.py:_awsp_kernel`` (``_awsp_call``, for both
its static plan and its device plan).

A plan is a (P,) int32 list of group ids and a (1,) int32 device count
``k`` of live positions; the kernel visits windows ``plan[p]*G ..
plan[p]*G + G-1`` for ``p < k``. vals/idx/x carry one extra all-zero group
(id ``ng``) that plan padding and an all-zero X point at.

The launch grid is sized from P, never from ``k``, so a device plan runs
with no host sync: ``slices`` blocks a column group and batch tile
(``awsp_slices``: the grid fills the card's resident blocks once). Each
block reads ``k`` and takes its even part of the group's ``k*G*W`` live
slot rows (``live_parts``), so a plan with few live groups still spreads
over the card; the blocks past the last part read nothing. A part streams
through a ring of bulk-copied stages of up to ``STAGE_ROWS`` rows, and
the last part to arrive adds the parts in order (one launch a call).

``device_group_plan`` builds the device plan ``(plan, k)`` from X: one
kernel (``csrc/group_plan.cu``) for a CUDA X, ``device_group_plan_plain``
(torch ops, the JAX package's ``device_group_plan``) for a CPU X. K9's
device plan (``formats/awsp.py:PlanSkip``) is the same function over
128-row windows.

``awsp_spmm`` launches the CUDA kernel for CUDA tensors and uses
``awsp_spmm_plain`` only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.dense import batch_tile
from tpusparse_torch.trace import spanned
from tpusparse_torch.utils import cdiv

_LANES = 128
_VALS_KIND = {torch.float32: 0, torch.bfloat16: 1}
# csrc/awsp_spmv.cu: slot rows a ring stage, stages, the mbarriers' header,
# and the rows a part is a multiple of (one a warp)
STAGE_ROWS = 32
STAGES = 3
_HEADER = 128
QUANTUM = 4
_STATIC = 1024            # a block's static shared memory: its plan entries
_MAX_RESIDENT = {1: 2, 2: 2, 4: 2, 8: 3}   # blocks an SM, by batch tile


def awsp_smem_bytes(bt: int, itemsize: int) -> int:
    """Dynamic shared memory of a K3 block (``kAwspSmem``): the mbarriers
    and a ring of STAGES stages, each STAGE_ROWS slot rows of values and
    offsets and the x window of ``bt`` batch rows."""
    stage = STAGE_ROWS * _LANES * (itemsize + 1) + bt * _LANES * 4
    return _HEADER + STAGES * stage


def awsp_slices(nb: int, tiles: int, rows: int, bt: int, itemsize: int,
                sms: int) -> int:
    """Blocks a (column group, batch tile) of a K3 call: the most for which
    ``nb`` x ``tiles`` x slices blocks fit the card's resident blocks once
    (three an SM at 8 batch rows, as many as the shared memory holds; two
    at 1-4 rows, where fewer, longer parts measured faster on an H100,
    PERF.md), and no more than ``rows`` (the full plan's slot rows a group)
    has parts of QUANTUM rows."""
    resident = min(_MAX_RESIDENT[bt], _build.SM_SMEM
                   // (awsp_smem_bytes(bt, itemsize) + _STATIC + 1024))
    return max(1, min(cdiv(rows, QUANTUM), resident * sms // (nb * tiles)))


def live_parts(live: int, slices: int) -> tuple[int, int]:
    """(per, parts) of the device split (``awsp_stream_kernel``): a group's
    ``live`` slot rows in parts of ``per`` rows (a multiple of QUANTUM),
    part s covering rows [s*per, min(live, (s+1)*per)); at least one part
    (an empty one when nothing is live)."""
    per = cdiv(cdiv(live, slices), QUANTUM) * QUANTUM
    return per, (cdiv(live, per) if per else 1)


def device_group_plan_plain(x: torch.Tensor, ng: int,
                            span: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side activation plan ``(plan, k)`` in torch ops: ``plan`` is
    the (ng,)-length active-first compaction of group ids (inactive tail set
    to the zero group ``ng``), ``k`` the (1,) int32 active count clamped to
    >= 1 so an all-zero X still runs the one zero-group step. ``x`` may be
    narrower than ``ng * span`` (missing columns are zero). No ``.item()``,
    no host sync."""
    rows = ng * span
    live = (x[:, :rows] != 0).any(dim=0)
    if live.numel() < rows:
        live = torch.cat([live, live.new_zeros(rows - live.numel())])
    act = live.reshape(ng, span).any(dim=1)
    count = act.sum(dtype=torch.int32)
    ids = torch.argsort((~act).to(torch.uint8), stable=True)  # active first
    plan = torch.where(torch.arange(ng, device=x.device) < count, ids,
                       ng).to(torch.int32)
    return plan, count.clamp(min=1).reshape(1)


@spanned("tps.launch")
def device_group_plan(x: torch.Tensor, ng: int,
                      span: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device plan ``(plan, k)`` of ``device_group_plan_plain``, bit for
    bit: one launch of ``csrc/group_plan.cu`` for a CUDA x (B, m) fp32, the
    plain version for a CPU x. No host sync."""
    if x.device.type == "cpu":
        return device_group_plan_plain(x, ng, span)
    if x.dtype != torch.float32 or x.ndim != 2 or ng < 1 or span < 1:
        raise ValueError(f"device_group_plan: x {x.dtype} {tuple(x.shape)}, "
                         f"ng={ng}, span={span}")
    dev = _build.require_cuda("device_group_plan", x)
    plan = torch.empty(ng, dtype=torch.int32, device=dev)
    k = torch.empty(1, dtype=torch.int32, device=dev)
    counters = _build.arrival_counters(dev, 1 + ng)   # a counter, ng flags
    rc = _build.lib().tps_group_plan(
        x.data_ptr(), plan.data_ptr(), k.data_ptr(), counters.data_ptr(),
        x.shape[0], x.shape[1], ng, span, dev.index, _build.stream_of(x))
    _build.check(rc, "device_group_plan")
    device_group_plan.launches += 1
    return plan, k


device_group_plan.launches = 0


def awsp_spmm_plain(plan: torch.Tensor, k: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor, x: torch.Tensor, *, g: int,
                    n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3 on any device (no host sync either)."""
    nb = vals.shape[0]
    n = nb * _LANES if n is None else n
    dev = x.device
    x = torch.nn.functional.pad(x, (0, vals.shape[1] * _LANES - x.shape[1]))
    live = (torch.arange(plan.numel(), device=dev) < k.reshape(()))
    win = (plan.long()[:, None] * g + torch.arange(g, device=dev)).reshape(-1)
    v = vals[:, win].float() * live.repeat_interleave(g).float() \
        .view(1, -1, 1, 1)
    col = (win * _LANES).view(1, -1, 1, 1) + idx[:, win].long()
    y = torch.empty((x.shape[0], nb * _LANES), dtype=torch.float32,
                    device=dev)
    for b in range(x.shape[0]):     # one row at a time bounds the temporary
        y[b] = (v * x[b][col]).sum(dim=(1, 2)).reshape(-1)
    return y[:, :n].contiguous()


@spanned("tps.launch")
def awsp_spmm(plan: torch.Tensor, k: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor, x: torch.Tensor, *, g: int,
              n: int | None = None) -> torch.Tensor:
    """K3: plan (P,) int32, k (1,) int32, idx/vals (nb, (ng+1)*G, W, 128),
    x (B, m) fp32 with m <= (ng+1)*G*128 (the kernel reads missing columns
    as 0) -> (B, n) fp32."""
    if x.device.type == "cpu":
        return awsp_spmm_plain(plan, k, idx, vals, x, g=g, n=n)
    nb, ntot, w, lanes = vals.shape
    if idx.shape != vals.shape or idx.dtype != torch.int8 or lanes != _LANES \
            or ntot % g:
        raise ValueError(f"awsp_spmm: idx {tuple(idx.shape)} {idx.dtype} vs "
                         f"vals {tuple(vals.shape)}, g={g}")
    if vals.dtype not in _VALS_KIND:
        raise ValueError(f"awsp_spmm: unsupported vals dtype {vals.dtype}")
    if plan.dtype != torch.int32 or k.dtype != torch.int32 or k.numel() != 1:
        raise ValueError("awsp_spmm: plan and k must be int32, k of size 1")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] > ntot * _LANES:
        raise ValueError(f"awsp_spmm: x must be fp32 (B, <={ntot * _LANES}), "
                         f"got {x.dtype} {tuple(x.shape)}")
    dev = _build.require_cuda("awsp_spmm", plan, k, idx, vals, x,
                              aligned=(idx, vals))
    n = nb * _LANES if n is None else n
    if not 0 <= n <= nb * _LANES:
        raise ValueError(f"awsp_spmm: n={n} outside [0, {nb * _LANES}]")
    batch = x.shape[0]
    if batch == 0 or n == 0:
        return torch.zeros((batch, n), dtype=torch.float32, device=dev)
    plan_len = plan.numel()
    bt = batch_tile(batch)
    tiles = cdiv(batch, bt)
    slices = awsp_slices(nb, tiles, plan_len * g * w, bt, vals.element_size(),
                         _build.sm_count(dev))
    part = torch.empty((slices, batch, nb * _LANES), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    counters = _build.arrival_counters(dev, nb * tiles)
    rc = _build.lib().tps_awsp_spmm(
        plan.data_ptr(), k.data_ptr(), idx.data_ptr(), vals.data_ptr(),
        _VALS_KIND[vals.dtype], x.data_ptr(), part.data_ptr(), y.data_ptr(),
        counters.data_ptr(), nb, ntot, g, plan_len, w, batch, x.shape[1],
        slices, n, dev.index, _build.stream_of(x))
    _build.check(rc, "awsp_spmm")
    awsp_spmm.launches += 1
    return y


awsp_spmm.launches = 0
