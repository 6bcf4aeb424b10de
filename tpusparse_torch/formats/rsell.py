"""RSELL: ragged SELL — per-tile widths through a flat chunk stream.

Counterpart of ``tpusparse/formats/rsell.py`` with the same pack, bit for
bit: each kept (window, column-group) tile stores ceil(demand / 8) chunks of
(8 slots x 128 lanes), so bytes track each tile's own widest column instead
of SELL's global W; all-zero tiles store nothing. ``cj`` and ``ct`` (each
chunk's output group and contraction window) stay two int32 arrays, as the
JAX package packs them before its TPU-only ``(cj << 16) | ct`` plan.

Packing runs on the host in numpy (the JAX package's numpy path; its C++
path is bit-identical to it and is not ported). ``sort="auto"`` sorts the
columns by nnz exactly when the router's skew test fires, and a sorted pack
carries the inverse permutation and its K5 plan, turned into one source
lane per output column and its inverse (``Unpermute``); ``RsellMatrix``
hands those to K4 (``kernels/rsell_spmv.py``), whose second kernel writes
the output in the user's column order, so a product is K4 alone.
``rsell_shard_pack`` (the multi-device packer) is not part of this port yet.
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


def rsell_pack_csr(csr: CsrMatrix, sort: bool | str = "auto") -> dict[str, Any]:
    """CsrMatrix (CSR of A.T) -> flat chunk stream, numpy arrays.
    ``sort``: order columns by nnz first; ``"auto"`` sorts exactly when the
    router's skew test fires (widest column >= 1.5 x the median)."""
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
