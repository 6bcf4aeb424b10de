"""K1: SELL SpMV/SpMM — ``csrc/sell_spmv.cu``, replacing the TPU kernel
``tpusparse/kernels/sell_spmv.py:_sell_kernel``.

``y[b, j*128+r] = sum_t sum_s vals[j,t,s,r] * x[b, t*128 + idx[j,t,s,r]]``,
times ``scales[j, r]`` for int8 storage (applied once, after the sum).
Storage may be fp32, bf16 or int8; accumulation is fp32. The result is
``(B, n)``: the TPU kernel's ``(B*8, N)`` output slab is not part of the
port.

Every call goes through a launch plan (``SellPlan``, made by
``sell_plan``): the checks, the ``SellShape`` and the C entry's arguments
for one pack, one shape of x and one stream, fixed once as ctypes objects.
A ``SellMatrix`` keeps its plans, so that a product it has made before on
the stream costs two allocations (the partial sums and y) and one ctypes
call whose other arguments were made with the plan; ``sell_spmm`` builds
a plan for its one call. A plan launches the CUDA
kernel for CUDA tensors and runs ``sell_spmm_plain`` only for CPU tensors;
any other device raises.

The CUDA code reads the pack once for every block of batch rows: up to 8
rows with 128-thread blocks of one or a few windows, from 9 rows with
blocks of 16 or 32 rows that each walk a run of windows through a ring of
bulk-copied tiles in shared memory (``sell_shape``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.trace import recording, span
from tpusparse_torch.utils import cdiv

_LANES = 128
_VALS_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_RING_WARPS = 8           # csrc/sell_spmv.cu kRingWarps
_HEADER = 128             # kRingHeader: the stages' mbarriers
_MAX_STAGES = 2           # kRingMaxStages (3 and 4 measured slower: PERF.md)
_MAX_BB = 32              # batch rows a block
_SMALL_BB = 8             # up to this, the 128-thread kernel


class SellShape(NamedTuple):
    """A K1 call's launch: ``bb`` batch rows a block (``nz`` blocks down the
    batch), ``per_slice`` windows a block, ``slices`` blocks along the
    windows; for the ring kernel (16 or 32 rows) ``stages`` tiles in the
    ring, ``resident`` blocks an SM and ``smem`` bytes of shared memory a
    block (0 for the 128-thread kernel)."""
    bb: int
    nz: int
    per_slice: int
    slices: int
    stages: int
    resident: int
    smem: int


def x_window_floats(bb: int) -> int:
    """Floats of one of the ring kernel's x windows for ``bb`` batch rows:
    128 transposed rows of bb + 4 floats (odd 16-byte units)."""
    return _LANES * (bb + 4)


def sell_smem_bytes(w: int, itemsize: int, bb: int, stages: int) -> int:
    """Dynamic shared memory of a ring kernel block (``csrc/sell_spmv.cu``
    ``sell_smem``): the ring of tiles and its x windows (at least two), or
    the row groups' sums at the end, whichever is larger."""
    ring = stages * w * _LANES * (itemsize + 1) \
        + 4 * max(stages, 2) * x_window_floats(bb)
    red = 4 * _RING_WARPS * _LANES * 4
    return _HEADER + max(ring, red)


def sell_shape(nb: int, nt: int, w: int, batch: int, itemsize: int, sms: int,
               smem_limit: int = _build.SMEM_LIMIT) -> SellShape:
    """The launch of a K1 call on a card of ``sms`` SMs and ``smem_limit``
    bytes of shared memory a block. Up to 8 rows, the 128-thread kernel: the
    batch in one batch tile of 1, 2, 4 or 8 rows, the windows cut so that
    about 8 blocks an SM fill the card (``_build.split_work``). From 9 rows
    the ring kernel: 16 or 32 rows a block (more take more blocks, each
    reading the pack again); two blocks an SM where each then has a ring of
    2 stages, else one with as many (up to 2) as fit; each block walks a run
    of windows, the runs filling the SMs once.
    Raises if one stage does not fit."""
    if batch <= _SMALL_BB:
        bb = 1 if batch <= 1 else 2 if batch == 2 else 4 if batch <= 4 else 8
        per, slices = _build.split_slices(nt, nb, sms)
        return SellShape(bb, 1, per, slices, 0, 8, 0)
    bb = 16 if batch <= 16 else _MAX_BB
    pair = sell_smem_bytes(w, itemsize, bb, _MAX_STAGES)
    two = pair <= smem_limit and 2 * (pair + 1024) <= _build.SM_SMEM
    resident = 2 if two else 1
    stages = _MAX_STAGES
    while stages > 1 and sell_smem_bytes(w, itemsize, bb,
                                         stages) > smem_limit:
        stages -= 1
    smem = sell_smem_bytes(w, itemsize, bb, stages)
    if smem > smem_limit:
        raise ValueError(f"sell_spmm: a tile of W = {w} needs {smem} bytes of "
                         f"shared memory, over the card's {smem_limit}")
    nz = cdiv(batch, bb)
    per, slices = _build.launch_shape(nt, nb * nz, resident * sms)
    return SellShape(bb, nz, per, slices, stages, resident, smem)


def sell_spmm_plain(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    *, scales: torch.Tensor | None = None,
                    n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1 on any device. idx/vals (nb, nt, W, 128),
    x (B, m) fp32 with m <= nt*128, scales (nb, 128) or None -> (B, n)."""
    nb, nt = vals.shape[0], vals.shape[1]
    n = nb * _LANES if n is None else n
    x = torch.nn.functional.pad(x, (0, nt * _LANES - x.shape[1]))
    # column of x each slot gathers: t*128 + idx
    col = (torch.arange(nt, device=x.device) * _LANES).view(1, nt, 1, 1) \
        + idx.long()
    v = vals.float()
    y = torch.empty((x.shape[0], nb * _LANES), dtype=torch.float32,
                    device=x.device)
    for b in range(x.shape[0]):     # one row at a time bounds the temporary
        y[b] = (v * x[b][col]).sum(dim=(1, 2)).reshape(-1)
    if scales is not None:
        y = y * scales.reshape(1, -1)
    return y[:, :n].contiguous()


def sell_spmm(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
              *, scales: torch.Tensor | None = None,
              n: int | None = None) -> torch.Tensor:
    """K1: idx (nb, nt, W, 128) int8, vals same shape (fp32/bf16/int8),
    x (B, m) fp32 with m <= nt*128 (the kernel reads missing columns as 0),
    scales (nb, 128) fp32 for int8 -> (B, n) fp32. A plan for this one call
    (``sell_plan``), run once."""
    return sell_plan(idx, vals, x, scales=scales, n=n).run(x)


sell_spmm.launches = 0


class SellPlan:
    """A K1 launch for one pack (``idx``, ``vals``, ``scales``, held), one
    shape of x (``batch`` rows of ``ldx``) and one stream: every check of a
    call done, its ``SellShape`` fixed and ``tps_sell_spmm``'s arguments
    other than x, the partial sums and y made as ctypes objects. Made by
    ``sell_plan``. ``run(x)`` then checks nothing of x: the caller gives an
    x of the plan's shape and dtype, contiguous, on its device, and calls
    on the plan's stream. Each run allocates its own partial sums, so that
    runs from several threads never share them. On the CPU a plan holds no
    launch and runs the plain version, as a call there always did."""

    __slots__ = ("idx", "vals", "scales", "n", "stream", "yshape", "vshape",
                 "pshape", "_fn", "_head", "_scales", "_tail")

    def __init__(self, idx, vals, x, scales, n, stream):
        self.idx, self.vals, self.scales = idx, vals, scales
        self.n, self._fn = n, None
        if x.device.type == "cpu":
            return
        nb, nt, w, lanes = vals.shape
        if idx.shape != vals.shape or idx.dtype != torch.int8 \
                or lanes != _LANES:
            raise ValueError(f"sell_spmm: idx {tuple(idx.shape)} {idx.dtype} "
                             f"vs vals {tuple(vals.shape)}")
        if vals.dtype not in _VALS_KIND:
            raise ValueError(f"sell_spmm: unsupported vals dtype {vals.dtype}")
        if (vals.dtype == torch.int8) != (scales is not None):
            raise ValueError("sell_spmm: int8 storage needs scales, and only "
                             "it")
        if x.dtype != torch.float32 or x.ndim != 2 \
                or x.shape[1] > nt * _LANES:
            raise ValueError(f"sell_spmm: x must be fp32 (B, <={nt * _LANES}),"
                             f" got {x.dtype} {tuple(x.shape)}")
        extra = () if scales is None else (scales,)
        if scales is not None and (scales.dtype != torch.float32
                                   or scales.numel() != nb * _LANES):
            raise ValueError("sell_spmm: scales must be fp32 (nb, 128)")
        n = nb * _LANES if n is None else n
        if not 0 <= n <= nb * _LANES:
            raise ValueError(f"sell_spmm: n = {n} outside 0 .. {nb * _LANES}")
        dev = _build.require_cuda("sell_spmm", idx, vals, x, *extra,
                                  aligned=(idx, vals))
        batch, ldx = x.shape
        shape = sell_shape(nb, nt, w, batch, vals.element_size(),
                           _build.sm_count(dev), _build.smem_limit(dev))
        self.stream = _build.raw_stream(dev.index) if stream is None \
            else stream
        self.n, self.yshape, self.vshape = n, (batch, n), (n,)
        self.pshape = (shape.slices, batch, nb * _LANES)
        p, i = ctypes.c_void_p, ctypes.c_int
        # tps_sell_spmm(idx, vals, vals_kind, x, scales, part, y, *tail)
        self._head = (p(idx.data_ptr()), p(vals.data_ptr()),
                      i(_VALS_KIND[vals.dtype]))
        self._scales = p(None if scales is None else scales.data_ptr())
        self._tail = tuple(i(v) for v in (
            nb, nt, w, batch, ldx, shape.slices, shape.per_slice, n,
            shape.bb, shape.stages, dev.index)) + (p(self.stream),)
        self._fn = _build.lib().tps_sell_spmm

    def run(self, x: torch.Tensor, vec: bool = False) -> torch.Tensor:
        """y = x A: (batch, n), or (n,) where ``vec`` (one row, x of
        shape (ldx,) or (1, ldx)). The C call runs in the ``tps.launch``
        span while a profiler records."""
        if self._fn is None:
            if recording():
                with span("tps.launch"):
                    return self._plain(x, vec)
            return self._plain(x, vec)
        part = x.new_empty(self.pshape)
        y = x.new_empty(self.vshape if vec else self.yshape)
        if recording():
            with span("tps.launch"):
                rc = self._fn(*self._head, x.data_ptr(), self._scales,
                              part.data_ptr(), y.data_ptr(), *self._tail)
        else:
            rc = self._fn(*self._head, x.data_ptr(), self._scales,
                          part.data_ptr(), y.data_ptr(), *self._tail)
        if rc:
            _build.check(rc, "sell_spmm")
        sell_spmm.launches += 1
        return y

    def _plain(self, x, vec):
        y = sell_spmm_plain(self.idx, self.vals, x.view(1, -1) if vec else x,
                            scales=self.scales, n=self.n)
        return y[0] if vec else y


def sell_plan(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
              scales: torch.Tensor | None = None, n: int | None = None,
              stream: int | None = None) -> SellPlan:
    """The ``SellPlan`` of ``sell_spmm(idx, vals, x, scales=scales, n=n)``
    on ``stream`` (a raw handle; None: the current stream of x's device).
    Raises what that call would. ``sell_plan.builds`` counts the plans
    built, ``sell_plan.hits`` the products that reused one and
    ``sell_plan.rebuilds`` the builds for a key whose plan had gone stale
    (the last two by ``SellMatrix``); none is ever reset."""
    plan = SellPlan(idx, vals, x, scales, n, stream)
    sell_plan.builds += 1
    return plan


sell_plan.builds = 0
sell_plan.hits = 0
sell_plan.rebuilds = 0
