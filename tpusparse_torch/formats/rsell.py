"""RSELL: ragged SELL — per-tile widths through a flat chunk stream.

Counterpart of ``tpusparse/formats/rsell.py`` with the same pack, bit for
bit: each kept (window, column-group) tile stores ceil(demand / 8) chunks of
(8 slots x 128 lanes), so bytes track each tile's own widest column instead
of SELL's global W; all-zero tiles store nothing. ``cj`` and ``ct`` (each
chunk's output group and contraction window) stay two int32 arrays, as the
JAX package packs them before its TPU-only ``(cj << 16) | ct`` plan.

Packing runs on the host, through the C++ converter (``native``) where it
built and in numpy otherwise; both give the same bits. ``sort="auto"`` sorts the
columns by nnz exactly when the router's skew test fires, and a sorted pack
carries the inverse permutation and its K5 plan, turned into one source
lane per output column and its inverse (``Unpermute``); ``RsellMatrix``
hands those to K4 (``kernels/rsell_spmv.py``), whose second kernel writes
the output in the user's column order, so a product is K4 alone.
``rsell_shard_pack`` packs one chunk stream a shard for the sharded maps
(``parallel/sparse.py:rsell_spmm_sharded``), bit for bit the JAX
package's ``RsellShards``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.csr import (CsrMatrix, col_window_widths,
                                         csr_rows_subset, segment_ranks)
from tpusparse_torch.formats.sell import _sorted_rows, as_input
from tpusparse_torch.kernels.permute import permute_plan, source_lanes
from tpusparse_torch.kernels.rsell_spmv import (check_plan_ids, rsell_plans,
                                                rsell_spmm, unpermute_lanes)
from tpusparse_torch.utils import resolve_device, round_up

_LANES = 128
_SUB = 8
_RUN = 8                       # run alignment quantum
# Align only when the group padding stays under this fraction of the
# stream (the JAX package's measured trade, kept so that packs compare).
_RUN_PAD_FRAC = 0.2


def rsell_pack_csr(csr: CsrMatrix, sort: bool | str = "auto",
                   use_native: bool | None = None) -> dict[str, Any]:
    """CsrMatrix (CSR of A.T) -> flat chunk stream, numpy arrays.
    ``sort``: order columns by nnz first; ``"auto"`` sorts exactly when the
    router's skew test fires (widest column >= 1.5 x the median).
    ``use_native``: the C++ demand and fill passes for fp32 values (None:
    where they built; True: raise when they did not)."""
    m, n_orig = csr.shape
    mp = round_up(m, _LANES)
    np_ = round_up(n_orig, _LANES)
    if sort == "auto":
        cw = col_window_widths(csr)
        med = float(np.median(cw)) if cw.size else 0.0
        sort = med > 0 and int(cw.max()) >= 1.5 * med
    inv_perm = None
    perm_plan = None
    if sort:
        col_nnz = np.zeros(np_, dtype=np.int64)
        col_nnz[:n_orig] = csr.row_nnz
        perm = np.argsort(-col_nnz, kind="stable").astype(np.int32)
        csr = csr_rows_subset(csr, perm)          # (m, np_), sorted columns
        inv_perm = np.empty(np_, dtype=np.int32)
        inv_perm[perm] = np.arange(np_, dtype=np.int32)
        pp = permute_plan(inv_perm)
        perm_plan = (pp["oidx"], pp["oh"])

    n = csr.shape[1]
    nt = mp // _LANES
    csr = _sorted_rows(csr)

    from tpusparse_torch import native

    if use_native is not False and csr.nnz and \
            csr.values.dtype == np.float32 and native.available():
        demand = native.rsell_demand_csr(csr.row_ptr, csr.col_idx, n, nt)
        flat = demand.ravel()
        tiles = np.flatnonzero(flat).astype(np.int64)
        w_jt = flat[tiles].astype(np.int64)
        tile_chunks = -(-w_jt // _SUB)
        tile_base = np.concatenate([[0], np.cumsum(tile_chunks)])
        nchunk = int(tile_base[-1])
        base_grid = np.zeros(flat.size, np.int64)
        base_grid[tiles] = tile_base[:-1]
        vals, idx = native.rsell_fill_csr(
            csr.row_ptr, csr.col_idx, csr.values, n, nt, base_grid, nchunk)
        cj = (tiles // nt).astype(np.int32).repeat(tile_chunks)
        ct = (tiles % nt).astype(np.int32).repeat(tile_chunks)
        return _finish_pack(cj, ct, idx, vals, nchunk, int(w_jt.max()), m,
                            n_orig, mp, np_, csr.nnz, inv_perm, perm_plan)
    if use_native and csr.nnz:
        raise RuntimeError("native converters requested but unavailable "
                           f"(library loaded: {native.available()}, values "
                           f"dtype: {csr.values.dtype})")

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    bi = mi // _LANES

    if r.size:
        # rank within each (column, window) run — entries sorted by (r, mi)
        rank, grp_start, grp_counts = segment_ranks(r, bi)
        tkey = (r // _LANES) * nt + bi         # tiles sorted by (group, win)
        tiles, tinv = np.unique(tkey, return_inverse=True)
        w_jt = np.zeros(tiles.size, dtype=np.int64)
        run_tile = np.searchsorted(tiles, (r[grp_start] // _LANES) * nt +
                                   bi[grp_start])
        np.maximum.at(w_jt, run_tile, grp_counts)
        tile_chunks = -(-w_jt // _SUB)
        tile_base = np.concatenate([[0], np.cumsum(tile_chunks)])
        nchunk = int(tile_base[-1])

        cj = (tiles // nt).astype(np.int32).repeat(tile_chunks)
        ct = (tiles % nt).astype(np.int32).repeat(tile_chunks)
        idx = np.zeros((nchunk, _SUB, _LANES), dtype=np.int8)
        vals = np.zeros((nchunk, _SUB, _LANES), dtype=csr.values.dtype)
        chunk = tile_base[tinv] + rank // _SUB
        idx[chunk, rank % _SUB, r % _LANES] = (mi % _LANES).astype(np.int8)
        vals[chunk, rank % _SUB, r % _LANES] = csr.values
        w_max = int(w_jt.max())
    else:
        nchunk = 0
        cj = np.zeros(0, np.int32)
        ct = np.zeros(0, np.int32)
        idx = np.zeros((0, _SUB, _LANES), np.int8)
        vals = np.zeros((0, _SUB, _LANES), np.float32)
        w_max = 0
    return _finish_pack(cj, ct, idx, vals, nchunk, w_max, m, n_orig, mp, np_,
                        csr.nnz, inv_perm, perm_plan)


def _run_align(cj, ct, idx, vals):
    """Pad each output group's chunk list to a multiple of _RUN, so every
    _RUN-chunk sub-block of the stream shares one cj. Pad chunks carry the
    group's cj and zero vals. Needs cj sorted ascending (pack order): the
    position map below assumes each group's chunks are contiguous, so an
    unsorted stream raises instead of packing wrong.

    Returns (cj, ct, idx, vals) aligned, or None when the padding would
    exceed _RUN_PAD_FRAC of the stream."""
    n = len(cj)
    if n == 0:
        return None
    if np.any(np.diff(cj) < 0):
        raise ValueError("_run_align needs cj sorted ascending (pack order)")
    groups, counts = np.unique(cj, return_counts=True)
    aligned = -(-counts // _RUN) * _RUN
    pad_total = int(aligned.sum() - n)
    if pad_total == 0:
        return cj, ct, idx, vals
    if pad_total > _RUN_PAD_FRAC * n:
        return None
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    new_starts = np.concatenate([[0], np.cumsum(aligned)[:-1]])
    # old chunk i of group g maps to new_starts[g] + (i - starts[g])
    ginv = np.repeat(np.arange(groups.size), counts)
    pos = new_starts[ginv] + (np.arange(n) - starts[ginv])
    total = int(aligned.sum())
    cj2 = np.repeat(groups.astype(np.int32), aligned)
    ct2 = np.zeros(total, np.int32)
    idx2 = np.zeros((total, _SUB, _LANES), np.int8)
    vals2 = np.zeros((total, _SUB, _LANES), vals.dtype)
    ct2[pos] = ct
    idx2[pos] = idx
    vals2[pos] = vals
    return cj2, ct2, idx2, vals2


def _pad_chunks(cj, ct, idx, vals, extra: int):
    """Append ``extra`` zero chunks of group 0, window 0."""
    return (np.concatenate([cj, np.zeros(extra, np.int32)]),
            np.concatenate([ct, np.zeros(extra, np.int32)]),
            np.concatenate([idx, np.zeros((extra, _SUB, _LANES), np.int8)]),
            np.concatenate([vals, np.zeros((extra, _SUB, _LANES),
                                           vals.dtype)]))


def _finish_pack(cj, ct, idx, vals, nchunk, w_max, m, n_orig, mp, np_, nnz,
                 inv_perm, perm_plan):
    """Run-align the stream where the padding allows it, then pad it as the
    JAX package does, so the packs compare array for array."""
    if nchunk == 0:                            # the stream holds >= 1 chunk
        cj = np.zeros(1, np.int32)
        ct = np.zeros(1, np.int32)
        idx = np.zeros((1, _SUB, _LANES), np.int8)
        vals = np.zeros((1, _SUB, _LANES), np.float32)
    run = 1
    aligned = _run_align(cj, ct, idx, vals) if nchunk else None
    if aligned is not None:
        cj, ct, idx, vals = aligned
        run = _RUN
    # the JAX package pads long streams to a multiple of 128 chunks (its
    # grid step) and short ones to 8; the tail is zero chunks of group 0
    align = 128 if len(cj) >= 1024 else _SUB
    pad = -len(cj) % align if len(cj) >= 64 else 0
    if pad:
        cj, ct, idx, vals = _pad_chunks(cj, ct, idx, vals, pad)
    if run > 1 and len(cj) % _RUN:             # short-list guard (<64)
        cj, ct, idx, vals = _pad_chunks(cj, ct, idx, vals, -len(cj) % _RUN)
    return dict(cj=cj, ct=ct, idx=idx, vals=vals, shape=(m, n_orig),
                padded=(mp, np_), nnz=int(nnz), n_real=nchunk,
                w_max=w_max, inv_perm=inv_perm, perm_plan=perm_plan, run=run)


class RsellMatrix:
    """RSELL-packed A held as tensors on one device."""

    def __init__(self, cj: torch.Tensor, ct: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor, shape, padded, nnz: int, n_real: int,
                 w_max: int, run: int = 1, inv_perm=None, perm_plan=None):
        self.cj = cj                   # (nchunk,) int32 output group
        self.ct = ct                   # (nchunk,) int32 contraction window
        self.idx = idx                 # (nchunk, 8, 128) int8
        self.vals = vals               # (nchunk, 8, 128) fp32
        self.shape = tuple(shape)
        self.padded = tuple(padded)
        self.nnz = nnz
        self.n_real = n_real           # chunks before zero padding
        self.w_max = w_max             # widest tile demand (diagnostic)
        self.run = run                 # pack run alignment (1 = flat)
        self.inv_perm = inv_perm       # numpy, None when packed unsorted
        self.perm_plan = perm_plan     # the JAX-layout (oidx, oh), numpy
        check_plan_ids(*self.padded)
        dev = self.device
        # one source lane per output column, and its inverse, which K4's
        # second kernel writes through
        self.unpermute = None if perm_plan is None else unpermute_lanes(
            source_lanes(*perm_plan, self.shape[1]), self.padded[1], dev)
        self.perm_src = None if perm_plan is None else self.unpermute.src
        # K4's work plans, one per batch tile, built once from host copies
        self._work = None if dev.type != "cuda" else rsell_plans(
            cj.cpu().numpy(), ct.cpu().numpy(), self.padded[1] // _LANES,
            dev)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def __repr__(self) -> str:
        return (f"RsellMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"chunks={self.n_real}, w_max={self.w_max}, run={self.run}, "
                f"device={self.device}, {self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def _from_pack(cls, p: dict[str, Any], device) -> "RsellMatrix":
        dev = resolve_device(device)
        tensors = {k: torch.from_numpy(p[k]).to(dev)
                   for k in ("cj", "ct", "idx", "vals")}
        meta = {k: p[k] for k in ("shape", "padded", "nnz", "n_real", "w_max",
                                  "run", "inv_perm", "perm_plan")}
        return cls(**tensors, **meta)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, device=None) -> "RsellMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        resolve_device(device)             # fail before packing, not after
        return cls._from_pack(rsell_pack_csr(csr), device)

    @classmethod
    def from_dense(cls, a, device=None) -> "RsellMatrix":
        """Dense A (numpy or tensor) on ``device`` (None: the GPU)."""
        resolve_device(device)
        return cls._from_pack(rsell_pack_csr(CsrMatrix.from_dense(a)), device)

    def device_bytes(self) -> int:
        """Bytes of the chunk stream: values, indices, cj and ct."""
        return self.vals.numel() * (self.vals.element_size() + 1) + \
            self.cj.numel() * 8

    def read_bytes(self) -> int:
        """The bytes a product must read: the live values with their
        one-byte indices, and each chunk's cj and ct. The padded slots of
        each 8 x 128 chunk are zero and need not be read."""
        return self.nnz * (self.vals.element_size() + 1) + \
            self.cj.numel() * 8

    def to_dense(self) -> torch.Tensor:
        """Dense A on the host."""
        mp, np_ = self.padded
        idx, vals = self.idx.cpu().numpy(), self.vals.cpu().numpy()
        a = np.zeros((mp, np_), dtype=vals.dtype)
        kk, ss, rr = np.nonzero(vals)
        cc = idx[kk, ss, rr].astype(np.int64)
        cj, ct = self.cj.cpu().numpy(), self.ct.cpu().numpy()
        a[ct[kk] * _LANES + cc, cj[kk] * _LANES + rr] = vals[kk, ss, rr]
        if self.inv_perm is not None:
            a = a[:, self.inv_perm]
        return torch.from_numpy(np.ascontiguousarray(
            a[:self.shape[0], :self.shape[1]]))

    def _run(self, x2d: torch.Tensor) -> torch.Tensor:
        mp, np_ = self.padded
        if x2d.ndim != 2 or x2d.shape[1] > mp:
            raise ValueError(f"x must be (b, <={mp}), got {tuple(x2d.shape)}")
        # no padding to the packed rows: the kernel reads them as zero
        # a sorted pack: K4's second kernel writes the user's column order
        n = self.shape[1] if self.unpermute is None else None
        return rsell_spmm(self.cj, self.ct, self.idx, self.vals,
                          x2d.contiguous(), n_padded=np_, n=n,
                          plan=self._work, unpermute=self.unpermute)

    def spmv(self, x) -> torch.Tensor:
        """x: (m,) -> y = x @ A, (n,)."""
        return self._run(as_input(x, self.device)[None, :])[0]

    def spmm(self, x) -> torch.Tensor:
        """x: (b, m) -> Y = X @ A, (b, n)."""
        return self._run(as_input(x, self.device))


class RsellShards:
    """Host-packed (numpy) chunk streams, one a shard, and the output
    placement: the JAX package's ``RsellShards``, array for array. A rank
    of ``rsell_spmm_sharded`` uploads its own row of each array."""

    def __init__(self, cj, ct, idx, vals, group_map, shape, padded, nnz,
                 counts, w_shard, perm_plan=None, run: int = 1):
        self.run = run                 # uniform pack run alignment
        self.cj = cj                   # (D, Lmax) int32 local group
        self.ct = ct                   # (D, Lmax) int32 window
        self.idx = idx                 # (D, Lmax, 8, 128) int8
        self.vals = vals               # (D, Lmax, 8, 128)
        self.group_map = group_map     # (D, nb_loc) sorted group id or -1
        self.shape = tuple(shape)
        self.padded = tuple(padded)
        self.nnz = nnz
        self.counts = counts           # (D,) real chunks per shard
        self.w_shard = w_shard         # (D,) max tile demand per shard
        self.perm_plan = perm_plan     # column unpermute (None: in order)
        # K5's source lane of each output column, over the shards' outputs
        # in (shard, local column) order
        self.perm_src = None if perm_plan is None else \
            source_lanes(*perm_plan, self.shape[1])

    @property
    def n_shards(self) -> int:
        return self.cj.shape[0]

    @property
    def balance(self) -> float:
        """max/mean real-chunk load; 1.0 is perfectly balanced."""
        mean = float(self.counts.mean()) or 1.0
        return float(self.counts.max()) / mean

    def __repr__(self) -> str:
        c = self.counts
        return (f"RsellShards(shape={self.shape}, nnz={self.nnz}, "
                f"D={self.n_shards}, chunks/shard "
                f"[{int(c.min())}..{int(c.max())}] mean {c.mean():.0f}, "
                f"balance {self.balance:.2f}, "
                f"w/shard [{int(self.w_shard.min())}.."
                f"{int(self.w_shard.max())}])")


def rsell_shard_pack(csr_or_dense, n_shards: int,
                     assignment: str = "balance",
                     sort: bool | str = "auto") -> RsellShards:
    """Assign output COLUMNS to shards and pack each shard's own chunk
    list, as the JAX package does (column, not group, granularity: a few
    head columns in one group would cap a group-level balance).

    ``assignment``:
    - ``balance`` (default): deal the demand-ordered columns to the shards
      in a serpentine, so that every shard's k-th local group holds a
      similar demand mix;
    - ``sorted``: contiguous demand-ordered ranges (shard 0 the densest);
    - ``contiguous``: shard d takes columns [d*cps, (d+1)*cps) in their own
      order, no sort and no output permutation (``perm_plan`` None).

    No divisibility requirement: trailing shards take empty columns, and
    the chunk lists pad with zero chunks to the longest. Every shard's
    stream obeys ``check_plan_ids`` and the uniform run alignment."""
    csr = csr_or_dense if isinstance(csr_or_dense, CsrMatrix) else \
        CsrMatrix.from_dense(csr_or_dense)
    m, n = csr.shape
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    if assignment == "contiguous":
        sort = False
    elif sort == "auto":
        cw = col_window_widths(csr)
        med = float(np.median(cw)) if cw.size else 0.0
        sort = med > 0 and int(cw.max()) >= 1.5 * med
    col_nnz = np.zeros(np_, dtype=np.int64)
    col_nnz[:n] = csr.row_nnz
    order = np.argsort(-col_nnz, kind="stable") if sort \
        else np.arange(np_, dtype=np.int64)

    nb = np_ // _LANES
    nb_loc = -(-nb // n_shards)
    cps = nb_loc * _LANES                        # columns per shard
    total = n_shards * cps
    assign = np.full((n_shards, cps), np_, dtype=np.int64)  # np_ == empty
    if assignment == "balance":
        k = np.arange(np_)
        cyc = k % (2 * n_shards)                 # serpentine deal
        d = np.where(cyc < n_shards, cyc, 2 * n_shards - 1 - cyc)
        assign[d, k // n_shards] = order
    elif assignment in ("sorted", "contiguous"):
        padded = np.concatenate(
            [order, np.full(total - np_, np_, dtype=np.int64)])
        assign = padded.reshape(n_shards, cps)
    else:
        raise ValueError(f"unknown assignment {assignment!r}")

    packs = [rsell_pack_csr(csr_rows_subset(csr, assign[d]), sort=False)
             for d in range(n_shards)]
    for p in packs:
        check_plan_ids(*p["padded"])
    counts = np.array([p["n_real"] for p in packs], dtype=np.int64)
    w_shard = np.array([p["w_max"] for p in packs], dtype=np.int64)
    # one run flag for every shard: run-aligned only where every shard's
    # pack aligned (an aligned pack is still right under the flat body)
    run = _RUN if all(p["run"] == _RUN for p in packs) else 1
    lmax = max(int(max(p["cj"].shape[0] for p in packs)), 1)
    if run > 1:
        lmax = -(-lmax // _RUN) * _RUN
    cj_s = np.zeros((n_shards, lmax), np.int32)
    ct_s = np.zeros((n_shards, lmax), np.int32)
    idx_s = np.zeros((n_shards, lmax, _SUB, _LANES), np.int8)
    val_s = np.zeros((n_shards, lmax, _SUB, _LANES), csr.values.dtype)
    for d, p in enumerate(packs):
        k = p["cj"].shape[0]
        cj_s[d, :k] = p["cj"]
        ct_s[d, :k] = p["ct"]
        idx_s[d, :k] = p["idx"]
        val_s[d, :k] = p["vals"]

    # one column-granular unpermute: original column c sits at flat output
    # lane d * cps + slot where assign[d, slot] == c
    if assignment == "contiguous":
        perm_plan = None
    else:
        flat = assign.ravel()
        real = flat < np_
        pos_of = np.empty(np_ + 1, dtype=np.int64)
        pos_of[flat[real]] = np.flatnonzero(real)
        pp = permute_plan(pos_of[:n], src_size=total)
        perm_plan = (pp["oidx"], pp["oh"])
    group_map = (assign[:, ::_LANES] // _LANES).astype(np.int32)  # info only
    return RsellShards(cj_s, ct_s, idx_s, val_s, group_map,
                       (m, n), (mp, np_), int(csr.nnz), counts, w_shard,
                       perm_plan=perm_plan, run=run)
