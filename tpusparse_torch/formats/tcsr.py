"""TCSR: block-skip 128 x 128 tiles, each stored in a SELL tier or a dense
tier — see kernels/bsell_spmv.py (K7) and kernels/bsr_spmv.py (K6).

Counterpart of ``tpusparse/formats/tcsr.py`` with the same pack, bit for bit:

- **SELL tier**: (W, 128) packed values + int8 in-window offsets per tile,
  bytes proportional to the tile's nnz, all tiles at one width W; K7.
- **dense tier**: the plain BSR tile (``formats/bsr.py``); K6.

Each kept tile goes to the tier of least modeled cost (``_tier_cutoff``).
The model's constants were measured on a TPU (the lane-gather floor, the
cost of running both tier kernels in one call) and are kept as they are so
that both packages choose the same tiers and give the same packs;
re-deriving them on the H100 is ROADMAP.md item 13's work. Packing runs on
the host in numpy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.bsr import BsrMatrix, bsr_pack_blocks
from tpusparse_torch.formats.csr import CsrMatrix, segment_ranks
from tpusparse_torch.formats.sell import _sorted_rows, as_input
from tpusparse_torch.kernels.bsell_spmv import bsell_plans, bsell_spmm
from tpusparse_torch.kernels.bsr_spmv import bsr_spmm
from tpusparse_torch.trace import spanned
from tpusparse_torch.utils import resolve_device, round_up

_LANES = 128
_SUB = 8

# The JAX package's cost model, measured on a TPU (tpusparse/formats/
# tcsr.py:40-52): SELL-tier bytes per slot row, the lane-gather floor per
# slot row and batch column (byte-equivalents), the dense tile, and the
# charge for running both tier kernels in one call.
_SELL_BYTES_PER_W = 5 * _LANES
_GATHER_BYTE_EQ_PER_W = 545
_DENSE_TILE_BYTES = _LANES * _LANES * 4
_TIER_SPLIT_BYTES = 12 << 20


def _tier_cutoff(w_b: np.ndarray, expect_batch: int,
                 tile_bj: np.ndarray | None = None,
                 nb: int | None = None) -> int:
    """Largest SELL-tier width W minimizing the modeled cost when all tiles
    with w_b <= W go SELL (at width W) and the rest go dense; 0 means every
    tile is cheaper dense. The cost counts each tier's stored tiles as its
    canonicalization leaves them (zero tiles for the output groups a tier
    misses, long-list padding), plus the split charge when both tiers are
    used."""
    if w_b.size == 0:
        return 0
    if tile_bj is None:
        tile_bj = np.zeros(w_b.size, dtype=np.int64)
        nb = 1
    per_w = max(_SELL_BYTES_PER_W, _GATHER_BYTE_EQ_PER_W * max(expect_batch, 1))

    def stored(sel: np.ndarray) -> int:
        k = int(sel.sum())
        if k == 0:
            return 0
        k += nb - np.unique(tile_bj[sel]).size       # missing-group zeros
        if k >= 64:
            k += -k % _SUB
        return k

    def total(cand: int) -> int:
        sel = w_b <= cand
        split = _TIER_SPLIT_BYTES if (stored(sel) and stored(~sel)) else 0
        return per_w * cand * stored(sel) + \
            _DENSE_TILE_BYTES * stored(~sel) + split

    best_w = 0
    best_cost = total(0)
    for cand in sorted({int(round_up(int(v), _SUB)) for v in w_b}):
        cost = total(cand)
        if cost < best_cost:
            best_w, best_cost = cand, cost
    return best_w


def _canonicalize_sell_tiles(s_bi, s_bj, idx, vals, nb: int, w: int):
    """The JAX package's SELL-tier list invariants, kept so the packs
    compare: sorted by (bj, bi) (already true from ``np.unique``), every
    output group present (zero tiles inserted), and lists of 64 tiles or
    more padded with zero tiles at the last group to a multiple of 8, or of
    64 from 512."""
    missing = np.setdiff1d(np.arange(nb), s_bj)
    if missing.size:
        ins = np.searchsorted(s_bj, missing)
        s_bi = np.insert(s_bi, ins, 0)
        s_bj = np.insert(s_bj, ins, missing)
        zero = np.zeros((missing.size, w, _LANES), vals.dtype)
        idx = np.insert(idx, ins, np.zeros_like(zero, np.int8), axis=0)
        vals = np.insert(vals, ins, zero, axis=0)
    align = 64 if len(s_bj) >= 512 else _SUB
    pad = -len(s_bj) % align if len(s_bj) >= 64 else 0
    if pad:
        s_bi = np.concatenate([s_bi, np.zeros(pad, s_bi.dtype)])
        s_bj = np.concatenate([s_bj, np.full(pad, nb - 1, s_bj.dtype)])
        idx = np.concatenate(
            [idx, np.zeros((pad, w, _LANES), np.int8)])
        vals = np.concatenate(
            [vals, np.zeros((pad, w, _LANES), vals.dtype)])
    return s_bi.astype(np.int32), s_bj.astype(np.int32), idx, vals


def tcsr_pack_csr(csr: CsrMatrix, expect_batch: int = 1) -> dict[str, Any]:
    """Pack from ``CsrMatrix`` (O(nnz + kept-tile payload) memory) into a
    numpy pack: the SELL tier ``s_bi``, ``s_bj``, ``idx``, ``vals`` at width
    ``w``, the dense tier as a BSR numpy pack ``bsr`` (or None), and
    ``shape``, ``padded``, ``nnz``, ``n_sell``, ``n_dense``. Feed
    deduplicated CSR (``from_scipy`` / ``from_dense`` are)."""
    m, n = csr.shape
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    mb, nb = mp // _LANES, np_ // _LANES
    csr = _sorted_rows(csr)      # the ranking below needs ascending m

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    bi, bj = mi // _LANES, r // _LANES
    tkey = bj * mb + bi                       # (bj, bi)-sorted tile ids
    tiles, tinv = np.unique(tkey, return_inverse=True)

    # per-(column, window) counts -> per-tile width demand w_b
    if r.size:
        ckey = r * mb + bi
        uk, counts = np.unique(ckey, return_counts=True)
        w_b = np.zeros(tiles.size, dtype=np.int64)
        ck_tile = np.searchsorted(tiles, ((uk // mb) // _LANES) * mb + uk % mb)
        np.maximum.at(w_b, ck_tile, counts)
    else:
        w_b = np.zeros(0, dtype=np.int64)

    w_cut = _tier_cutoff(w_b, expect_batch, tiles // mb, nb)
    sell_tiles = np.nonzero(w_b <= w_cut)[0] if w_cut else np.zeros(0, np.int64)
    dense_tiles = np.setdiff1d(np.arange(tiles.size), sell_tiles)
    is_sell_entry = np.isin(tinv, sell_tiles)

    # ---- SELL tier ---------------------------------------------------
    w = max(w_cut, _SUB) if sell_tiles.size else _SUB
    ns = sell_tiles.size
    idx = np.zeros((ns, w, _LANES), dtype=np.int8)
    vals = np.zeros((ns, w, _LANES), dtype=csr.values.dtype)
    if ns:
        # rank within each (column, window) run: entries sorted by (r, mi)
        rank, _, _ = segment_ranks(r, bi)
        slot_of_tile = np.full(tiles.size, -1, dtype=np.int64)
        slot_of_tile[sell_tiles] = np.arange(ns)
        e = is_sell_entry
        slot = slot_of_tile[tinv[e]]
        idx[slot, rank[e], r[e] % _LANES] = (mi[e] % _LANES).astype(np.int8)
        vals[slot, rank[e], r[e] % _LANES] = csr.values[e]
    s_bi = (tiles[sell_tiles] % mb).astype(np.int32)
    s_bj = (tiles[sell_tiles] // mb).astype(np.int32)
    if ns:          # an empty tier launches no kernel
        s_bi, s_bj, idx, vals = _canonicalize_sell_tiles(
            s_bi, s_bj, idx, vals, nb, w)

    # ---- dense tier ---------------------------------------------------
    bsr = None
    if dense_tiles.size:
        slot_of_tile = np.full(tiles.size, -1, dtype=np.int64)
        slot_of_tile[dense_tiles] = np.arange(dense_tiles.size)
        blocks = np.zeros((dense_tiles.size, _LANES, _LANES),
                          csr.values.dtype)
        e = ~is_sell_entry
        np.add.at(blocks, (slot_of_tile[tinv[e]], mi[e] % _LANES,
                           r[e] % _LANES), csr.values[e])
        bsr = bsr_pack_blocks(m, n, tiles[dense_tiles] % mb,
                              tiles[dense_tiles] // mb, blocks)

    return dict(s_bi=s_bi, s_bj=s_bj, idx=idx, vals=vals, w=w, bsr=bsr,
                shape=(m, n), padded=(mp, np_), nnz=int(csr.nnz),
                n_sell=int(ns), n_dense=int(dense_tiles.size))


class TcsrMatrix:
    """TCSR-packed A held as tensors on one device: the SELL tier's arrays
    and the dense tier as a ``BsrMatrix`` (or None)."""

    def __init__(self, s_bi: torch.Tensor, s_bj: torch.Tensor,
                 idx: torch.Tensor, vals: torch.Tensor, w: int,
                 bsr: BsrMatrix | None, shape, padded, nnz: int, n_sell: int,
                 n_dense: int):
        self.s_bi = s_bi               # (ns,) int32 contraction window
        self.s_bj = s_bj               # (ns,) int32 output group
        self.idx = idx                 # (ns, W, 128) int8
        self.vals = vals               # (ns, W, 128) fp32
        self.w = w
        self.bsr = bsr                 # the dense tier, or None
        self.shape = tuple(shape)
        self.padded = tuple(padded)
        self.nnz = nnz
        self.n_sell = n_sell           # real tiles of each tier
        self.n_dense = n_dense
        self._live: int | None = None  # SELL-tier nonzeros, counted once
        dev = self.device
        # K7's work plans, built once from the host copy of s_bj
        self._work = None if dev.type != "cuda" or not vals.shape[0] else \
            bsell_plans(s_bj.cpu().numpy(), self.padded[1] // _LANES, w, dev)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def __repr__(self) -> str:
        return (f"TcsrMatrix(shape={self.shape}, nnz={self.nnz}, w={self.w}, "
                f"sell_tiles={self.n_sell}, dense_tiles={self.n_dense}, "
                f"device={self.device}, {self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def _from_pack(cls, p: dict[str, Any], device) -> "TcsrMatrix":
        dev = resolve_device(device)
        tensors = {k: torch.from_numpy(p[k]).to(dev)
                   for k in ("s_bi", "s_bj", "idx", "vals")}
        bsr = None if p["bsr"] is None else BsrMatrix._from_pack(p["bsr"],
                                                                 dev)
        meta = {k: p[k] for k in ("w", "shape", "padded", "nnz", "n_sell",
                                  "n_dense")}
        return cls(**tensors, bsr=bsr, **meta)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, expect_batch: int = 1,
                 device=None) -> "TcsrMatrix":
        """Pack from ``CsrMatrix``; ``expect_batch`` moves the tier cutoff
        (the SELL tier pays its gather per batch column)."""
        resolve_device(device)           # fail before packing, not after
        return cls._from_pack(tcsr_pack_csr(csr, expect_batch=expect_batch),
                              device)

    @classmethod
    def from_dense(cls, a, expect_batch: int = 1,
                   device=None) -> "TcsrMatrix":
        """Dense A (numpy or tensor) on ``device`` (None: the GPU)."""
        resolve_device(device)
        return cls.from_csr(CsrMatrix.from_dense(a),
                            expect_batch=expect_batch, device=device)

    def device_bytes(self) -> int:
        """Bytes of both tiers: SELL values, indices and coordinates, and
        the dense tier's blocks and coordinates."""
        total = self.vals.numel() * (self.vals.element_size() + 1) + \
            self.s_bi.numel() * 8
        if self.bsr is not None:
            total += self.bsr.device_bytes()
        return int(total)

    def read_bytes(self) -> int:
        """The bytes a product must read of the pack: the SELL tier's live
        values with their one-byte indices and the coordinates of its real
        tiles, and the dense tier's ``read_bytes``. Zero slots, zero tiles
        and pad tiles need not be read."""
        if self._live is None:
            self._live = int(torch.count_nonzero(self.vals))
        total = self._live * (self.vals.element_size() + 1) + \
            self.n_sell * 8
        if self.bsr is not None:
            total += self.bsr.read_bytes()
        return int(total)

    def to_dense(self) -> torch.Tensor:
        """Dense A on the host."""
        mp, np_ = self.padded
        idx, vals = self.idx.cpu().numpy(), self.vals.cpu().numpy()
        a = np.zeros((mp, np_), dtype=vals.dtype)
        kk, ww, rr = np.nonzero(vals)
        cc = idx[kk, ww, rr].astype(np.int64)
        s_bi, s_bj = self.s_bi.cpu().numpy(), self.s_bj.cpu().numpy()
        a[s_bi[kk] * _LANES + cc, s_bj[kk] * _LANES + rr] = vals[kk, ww, rr]
        if self.bsr is not None:
            d = self.bsr.to_dense().numpy()
            a[:d.shape[0], :d.shape[1]] += d
        return torch.from_numpy(np.ascontiguousarray(
            a[:self.shape[0], :self.shape[1]]))

    def _run(self, x2d: torch.Tensor) -> torch.Tensor:
        """K7 on the SELL tier, K6 on the dense tier, their sum; zeros when
        both tiers are empty."""
        mp, np_ = self.padded
        if x2d.ndim != 2 or x2d.shape[1] > mp:
            raise ValueError(f"x must be (b, <={mp}), got {tuple(x2d.shape)}")
        x2d = x2d.contiguous()      # the kernels read missing rows as zero
        n = self.shape[1]
        y = None
        if self.vals.shape[0]:
            y = bsell_spmm(self.s_bi, self.s_bj, self.idx, self.vals, x2d,
                           n_padded=np_, n=n, plan=self._work)
        if self.bsr is not None:
            b = self.bsr
            yd = bsr_spmm(b.bi, b.bj, b.blocks, x2d, n_padded=np_, n=n,
                          plan=b._work)
            y = yd if y is None else y + yd
        if y is None:
            y = torch.zeros((x2d.shape[0], n), dtype=torch.float32,
                            device=x2d.device)
        return y

    @spanned("tps.spmv")
    def spmv(self, x) -> torch.Tensor:
        """x: (m,) -> y = x @ A, (n,)."""
        return self._run(as_input(x, self.device)[None, :])[0]

    @spanned("tps.spmm")
    def spmm(self, x) -> torch.Tensor:
        """x: (b, m) -> Y = X @ A, (b, n)."""
        return self._run(as_input(x, self.device))
