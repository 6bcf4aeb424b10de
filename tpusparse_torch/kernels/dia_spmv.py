"""K8: DIA SpMV — ``csrc/dia_spmv.cu``, replacing the TPU kernel
``tpusparse/kernels/dia_spmv.py:_dia_kernel`` (through
``dia_spmv_pallas``).

``y[p] = sum_i vals[i, p] * x[p + d_i]``, plus ``vals[i, p - d_i] *
x[p - d_i]`` for every ``d_i > 0`` when ``sym`` (the mirror of a bitwise-
symmetric operator stored as its ``d >= 0`` diagonals only); reads outside
``[0, n)`` come from the halo strips below, or are 0. One vector, a square
operator.

The TPU kernel's halo strips are inputs here too: ``xstrip_l`` (the
``hs = halo_rows(offsets, sym) * 128`` x values before position 0),
``xstrip_r`` (the hs after position n) and ``vstrip`` (``(k, hs)``, each vals
row's hs values before 0, read by a sym operator's mirrors). The sharded
halo partition (``parallel/sparse.py:dia_spmm_sharded``) passes a
neighbour's edges there; a strip left out reads as zeros, the one-device
case, with the same bits as before strips were an input. Its block sizing
(``_pick_rows``) is a VMEM budget; the sharded partition keeps a copy for
its slab width only. ``halo_rows`` and ``fits`` are kept verbatim, so that
``DiaMatrix`` picks the kernel exactly where the JAX package does.

The TPU kernel loads a block's x slab and halo once and forms every shifted
window from it. The CUDA kernel stages windows in shared memory instead:
``dia_plan`` (built once per matrix, ``DiaMatrix.plan``) lists the terms in
the TPU kernel's order and, for x and for each vals row, groups the shifts
at which the terms read it into windows of nearby shifts; a block of T
outputs copies each window once and forms its terms from it
(``csrc/dia_spmv.cu`` has the design). T is the first of ``TILES`` whose
windows fit ``budget(BLOCKS)``; windows that still do not fit stay in
global memory, the least used first.

``dia_spmv`` launches the CUDA kernel for CUDA tensors (its 16-byte copies
where ``vec_body`` holds, else its scalar body) and uses ``dia_spmv_plain``
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import round_up

_LANES = 128
_SUB = 8
_MAX_OFFSETS = 32          # the TPU kernel unrolls them; past this, no kernel
# csrc/dia_spmv.cu: 256 threads, 4 outputs a thread a pass; a warp takes
# 128 consecutive outputs, so a tile is a multiple of 128
PASS = 128
# The tiles dia_plan tries, in order: the first whose windows all fit two
# blocks an SM is taken, else the last, with its least used windows left in
# global memory. 1024 measured fastest at both K8 points, and a smaller
# tile that stages every window beat 1024 with terms read from global
# memory (scripts/k8_study.py, PERF.md).
TILES = (1024, 512, 256, 128)
BLOCKS = 2


def budget(blocks: int) -> int:
    """The staged bytes a block may hold for ``blocks`` blocks an SM."""
    return _build.SM_SMEM // blocks - 1024


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


class DiaPlan(NamedTuple):
    """K8's launch plan for one operator: ``tile`` positions a block;
    ``terms`` (e, s, row, xi, vi) in summation order (x read at p + e, vals
    row ``row`` at p + s; xi, vi the shared-memory index of the tile's
    first position's read, -1 where that window stays in global memory);
    ``windows`` (src, lo, len, off), the staged ones (src -1 is x, else a
    vals row; ``lo`` relative to the tile's base; all multiples of 4
    floats); ``smem_bytes`` their shared memory; ``words`` all of it as the
    C entry's int32 array."""
    tile: int
    terms: tuple
    windows: tuple
    smem_bytes: int
    words: object


def plan_terms(offsets, sym: bool) -> list[tuple[int, int, int]]:
    """(e, s, row) of each term in the TPU kernel's order: diagonal i
    (x at p + d_i, row i at p), then its mirror when ``sym`` and d_i > 0
    (x and row i at p - d_i)."""
    out = []
    for i, d in enumerate(offsets):
        out.append((d, 0, i))
        if sym and d > 0:
            out.append((-d, -d, i))
    return out


def shift_groups(shifts, tile: int) -> list[tuple[int, int]]:
    """(lo, hi) of the sorted distinct ``shifts`` cut where neighbours lie
    more than ``tile`` apart: one window [lo, tile + hi) then costs no more
    than two."""
    out = []
    for v in sorted(set(shifts)):
        if out and v - out[-1][1] <= tile:
            out[-1] = (out[-1][0], v)
        else:
            out.append((v, v))
    return out


def _windows(terms, tile: int) -> list[dict]:
    """Every window the terms read, x's first: its source, first shift
    ``lo`` (rounded down to 4), length (covering [lo, tile + hi), rounded
    up to 4) and the terms it serves."""
    sources = [(-1, [t[0] for t in terms])]
    rows = sorted({t[2] for t in terms})
    sources += [(r, [t[1] for t in terms if t[2] == r]) for r in rows]
    out = []
    for src, shifts in sources:
        for lo, hi in shift_groups(shifts, tile):
            lo4 = lo - lo % 4
            out.append(dict(src=src, lo=lo4, len=round_up(tile + hi - lo4, 4),
                            shifts=(lo, hi),
                            uses=sum(lo <= v <= hi for v in shifts)))
    return out


def dia_plan(offsets, sym: bool, tile: int | None = None,
             blocks: int = BLOCKS) -> DiaPlan:
    """K8's plan: the tile (None: the first of ``TILES`` whose windows all
    fit ``budget(blocks)``, else its last), the terms, and the windows
    staged within the budget; where they do not all fit, the least used
    stay in global memory (then the longest)."""
    if not 0 < len(offsets) <= _MAX_OFFSETS:
        raise ValueError(f"dia_plan: {len(offsets)} diagonals, the kernel "
                         f"takes 1 to {_MAX_OFFSETS}")
    terms = plan_terms(offsets, sym)
    room = budget(blocks)
    if tile is None:
        tile = next((t for t in TILES if 4 * sum(
            w["len"] for w in _windows(terms, t)) <= room), TILES[-1])
    if tile <= 0 or tile % PASS:
        raise ValueError(f"dia_plan: tile {tile} is no multiple of {PASS}")
    wins = _windows(terms, tile)
    total = sum(w["len"] for w in wins)
    for w in sorted(wins, key=lambda w: (w["uses"], -w["len"])):
        if 4 * total <= room:
            break
        w["off"] = None
        total -= w["len"]
    off = 0
    for w in wins:
        if w.get("off", 0) is not None:
            w["off"] = off
            off += w["len"]

    def index(src, v):
        for w in wins:
            if w["src"] == src and w["shifts"][0] <= v <= w["shifts"][1]:
                return -1 if w["off"] is None else w["off"] + v - w["lo"]
        raise AssertionError("a term with no window")

    plan_t = tuple((e, s_, r, index(-1, e), index(r, s_))
                   for e, s_, r in terms)
    staged = tuple((w["src"], w["lo"], w["len"], w["off"]) for w in wins
                   if w["off"] is not None)
    flat = [v for t in plan_t for v in t] + [v for w in staged for v in w]
    words = (ctypes.c_int32 * len(flat))(*flat)
    return DiaPlan(tile, plan_t, staged, 4 * off, words)


@functools.lru_cache(maxsize=64)
def _plan_of(offsets: tuple, sym: bool) -> DiaPlan:
    """``dia_plan`` for callers that pass none, built once per operator."""
    return dia_plan(offsets, sym)


def strip_width(offsets, sym: bool) -> int:
    """hs: the length of each halo strip, ``halo_rows * 128`` positions."""
    return halo_rows(offsets, sym) * _LANES


def check_reach(plan: DiaPlan, hs: int) -> None:
    """Raise unless every read of the plan lies within ``hs`` of [0, n):
    each staged window starts at or after -hs, and each term reads x at
    p + e with -hs <= e < hs and its vals row at p + s with s >= -hs. Then
    the strips hold every position an output in [0, n) reads outside it
    (the kernel reads positions further out as zeros; only outputs past n
    reach them)."""
    lo = min([w[1] for w in plan.windows]
             + [min(t[0], t[1]) for t in plan.terms])
    hi = max(t[0] for t in plan.terms)
    if lo < -hs or hi >= hs:
        raise ValueError(f"dia_spmv: the plan reads [{lo}, n + {hi}], past "
                         f"the {hs}-wide halo strips")


def _strips(offsets, sym: bool, xstrip_l, xstrip_r, vstrip, dev):
    """The three strips checked (None stays None), and hs."""
    hs = strip_width(offsets, sym)
    for name, t, shape in (("xstrip_l", xstrip_l, (hs,)),
                           ("xstrip_r", xstrip_r, (hs,)),
                           ("vstrip", vstrip, (len(offsets), hs))):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"dia_spmv: {name} must be contiguous fp32 "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return hs


def vec_body(vals: torch.Tensor, x: torch.Tensor, n: int,
             *strips: torch.Tensor | None) -> bool:
    """True where K8's 16-byte copies apply: n and the vals row stride
    multiples of 4, vals, x and every strip 16-byte aligned; else its scalar
    body."""
    return (n % 4 == 0 and vals.stride(0) % 4 == 0
            and all(t.data_ptr() % 16 == 0
                    for t in (vals, x, *strips) if t is not None))


def dia_spmv_plain(offsets, vals: torch.Tensor, x: torch.Tensor, *,
                   sym: bool, n: int, xstrip_l: torch.Tensor | None = None,
                   xstrip_r: torch.Tensor | None = None,
                   vstrip: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K8 on any device: for each position p, the
    same fp32 products added in the kernel's order (diagonal i, then its
    mirror). x is read through its strips outside [0, n) (``xstrip_l[hs +
    q]`` for q < 0, ``xstrip_r[q - n]`` for q >= n), a vals row at q < 0
    through ``vstrip[i, hs + q]``; a strip left out is zeros. vals (k, >= n),
    x (n,)."""
    hs = strip_width(offsets, sym)
    z = x.new_zeros(hs)
    xe = torch.cat([z if xstrip_l is None else xstrip_l.float(), x[:n],
                    z if xstrip_r is None else xstrip_r.float()])
    p = torch.arange(n, device=x.device)
    acc = torch.zeros(n, dtype=torch.float32, device=x.device)
    for i, d in enumerate(offsets):
        acc = acc + vals[i, :n].float() * xe[hs + p + d]
        if sym and d > 0:
            vl = z if vstrip is None else vstrip[i].float()
            ve = torch.cat([vl, vals[i, :n].float()])
            acc = acc + ve[hs + p - d] * xe[hs + p - d]
    return acc


def dia_spmv(offsets, vals: torch.Tensor, x: torch.Tensor, *, sym: bool,
             n: int, plan: DiaPlan | None = None,
             xstrip_l: torch.Tensor | None = None,
             xstrip_r: torch.Tensor | None = None,
             vstrip: torch.Tensor | None = None) -> torch.Tensor:
    """K8: offsets (k static ints, 0 < k <= 32), vals (k, >= n) fp32 (its
    rows may be a strided view, row stride >= n), x (n,) fp32 -> y (n,)
    fp32. ``plan``: ``dia_plan(offsets, sym)``; when None, the one built at
    the first call for these offsets (a ``DiaMatrix`` keeps its own).
    ``xstrip_l``, ``xstrip_r`` (hs,) and ``vstrip`` (k, hs) fp32, hs =
    ``strip_width(offsets, sym)``: the x values before 0 and from n, and the
    vals rows' values before 0 (None: zeros)."""
    if x.device.type == "cpu":
        return dia_spmv_plain(offsets, vals, x, sym=sym, n=n,
                              xstrip_l=xstrip_l, xstrip_r=xstrip_r,
                              vstrip=vstrip)
    k = len(offsets)
    if not 0 < k <= _MAX_OFFSETS:
        raise ValueError(f"dia_spmv: {k} diagonals, the kernel takes 1 to "
                         f"{_MAX_OFFSETS}")
    if vals.dtype != torch.float32 or vals.ndim != 2 or vals.shape[0] != k \
            or vals.shape[1] < n or vals.stride(1) != 1 \
            or vals.stride(0) < n:
        raise ValueError(f"dia_spmv: vals must be fp32 ({k}, >= {n}) with "
                         f"unit column stride, got {vals.dtype} "
                         f"{tuple(vals.shape)} strides {vals.stride()}")
    if x.dtype != torch.float32 or x.shape != (n,):
        raise ValueError(f"dia_spmv: x must be fp32 ({n},), got {x.dtype} "
                         f"{tuple(x.shape)}")
    dev = _build.require_cuda("dia_spmv", x)
    if vals.device != dev:
        raise ValueError(f"dia_spmv: vals on {vals.device}, x on {dev}")
    strips = (xstrip_l, xstrip_r, vstrip)
    hs = _strips(offsets, sym, *strips, dev)
    if plan is None:
        plan = _plan_of(tuple(int(d) for d in offsets), bool(sym))
    if any(t is not None for t in strips):
        check_reach(plan, hs)
    else:
        hs = 0                      # no strip: every read outside is zero
    y = torch.empty(n, dtype=torch.float32, device=dev)
    rc = _build.lib().tps_dia_spmv(
        ctypes.addressof(plan.words), vals.data_ptr(), x.data_ptr(),
        *(None if t is None else t.data_ptr() for t in strips),
        y.data_ptr(), len(plan.terms), len(plan.windows), plan.tile,
        plan.smem_bytes, int(vec_body(vals, x, n, *strips)), n,
        vals.stride(0), hs, dev.index, _build.stream_of(x))
    _build.check(rc, "dia_spmv")
    dia_spmv.launches += 1
    dia_spmv.strip_launches += any(t is not None for t in strips)
    return y


dia_spmv.launches = 0
dia_spmv.strip_launches = 0    # calls given at least one strip
