"""auto_format: pick the storage format from cheap matrix statistics.

Counterpart of ``tpusparse/formats/auto.py``: the statistics, the routing
decision and the byte predictions are the JAX package's, line for line, so
both routers give the same answer for the same matrix. Their thresholds
were measured on a TPU; re-deriving them on the H100 is later work
(ROADMAP.md, item 13). In short (the JAX module has the measurements):

- banded (few, mostly full diagonals): DIA;
- a batch whose gather bytes pass ~1.3x the dense bytes: TCSR when at
  least 40% of the 128x128 tiles are empty, else ASP (dense A + window
  skip);
- near-dense (d > 0.65): ASP;
- block-structured (>= 40% empty tiles): TCSR;
- skewed columns or window-concentrated nnz: RSELL when X and Y fit the
  TPU kernel's budget (``wide_fits``), else binned SELL (skew) or TCSR;
- otherwise SELL, or AWSP when the caller expects structured activations.

``auto_format`` packs every kind the router can pick into the port's
classes (``tcsr`` with the caller's ``expect_batch``, which moves its tier
cutoff). ``NOT_PORTED`` names a kind the port would lack; it is empty, and
``auto_format`` raises ``NotImplementedError`` for any kind in it rather
than substituting another format.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from tpusparse_torch.formats.csr import (CsrMatrix, _host_numpy,
                                         col_window_widths)
from tpusparse_torch.kernels.rsell_spmv import wide_fits
from tpusparse_torch.utils import resolve_device, round_up

_LANES = 128
# formats the router can pick that the port does not have yet, and
# the ROADMAP.md item that ports each: none since binned SELL (item 9)
NOT_PORTED: dict[str, str] = {}


def matrix_stats(a) -> dict[str, Any]:
    """Statistics driving format choice, from dense A (numpy or tensor).
    O(M*N); for matrices too large to densify use ``matrix_stats_csr``."""
    a = _host_numpy(a)
    m, n = a.shape
    mask = a != 0
    nnz = int(mask.sum())
    density = nnz / max(a.size, 1)

    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    mp_mask = np.zeros((mp, np_), dtype=bool)
    mp_mask[:m, :n] = mask
    tiles = mp_mask.reshape(mp // _LANES, _LANES, np_ // _LANES, _LANES)
    block_nnz = tiles.sum(axis=(1, 3))                    # (mb, nb)
    empty_block_frac = float((block_nnz == 0).mean())

    # SELL width demand per column (max window nnz): the global max against
    # the median column's demand
    win = tiles.sum(axis=1)                               # (mb, nb, 128)
    col_w = win.max(axis=0).ravel()[:n] if win.size else np.zeros(1)
    w_global = int(col_w.max()) if col_w.size else 0
    w_typical = float(np.median(col_w)) if col_w.size else 0.0

    # per-tile width demand: what a per-tile-width format stores,
    # round_up(w_tile, 8) slot rows of 5*128 bytes per occupied tile
    w_tile = win.max(axis=2)                              # (mb, nb)
    occ = w_tile > 0
    slot_tile_bytes = int((np.ceil(w_tile[occ] / 8) * 8).sum()) * 5 * _LANES

    ii, jj = np.nonzero(mask)
    n_diags = int(np.unique(ii - jj).size)
    # only the DIA admission branch reads diag_sym
    diag_sym = bool(m == n and 0 < n_diags <= 512
                    and np.array_equal(a, a.T))

    return dict(density=density, nnz=nnz,
                empty_block_frac=empty_block_frac,
                w_global=w_global, w_typical=w_typical, n_diags=n_diags,
                diag_sym=diag_sym, slot_tile_bytes=slot_tile_bytes)


def matrix_stats_csr(csr: CsrMatrix) -> dict[str, Any]:
    """The same statistics from (row_ptr, col_idx) in O(nnz), never
    touching an (m, n) dense array."""
    m, n = csr.shape
    nnz = csr.nnz
    density = nnz / max(m * n, 1)
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    mb, nb = mp // _LANES, np_ // _LANES

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    live = np.unique((mi // _LANES) * nb + (r // _LANES)).size
    empty_block_frac = 1.0 - live / max(mb * nb, 1)

    col_w = col_window_widths(csr)
    w_global = int(col_w.max()) if col_w.size else 0
    w_typical = float(np.median(col_w)) if col_w.size else 0.0

    if r.size:
        ckey = r * mb + (mi // _LANES)
        uk, counts = np.unique(ckey, return_counts=True)
        w_tile = np.zeros(mb * nb, dtype=np.int64)
        tkey = (uk % mb) * nb + (uk // mb) // _LANES
        np.maximum.at(w_tile, tkey, counts)
        occ = w_tile > 0
        slot_tile_bytes = int((np.ceil(w_tile[occ] / 8) * 8).sum()) * \
            5 * _LANES
    else:
        slot_tile_bytes = 0

    n_diags = int(np.unique(mi - r).size)

    # bitwise A == A.T in O(nnz log nnz), only when the DIA branch can ask
    diag_sym = False
    if m == n and 0 < n_diags <= 512:
        v = csr.values
        o1 = np.lexsort((r, mi))
        o2 = np.lexsort((mi, r))
        diag_sym = bool(np.array_equal(mi[o1], r[o2])
                        and np.array_equal(r[o1], mi[o2])
                        and np.array_equal(v[o1], v[o2]))

    return dict(density=density, nnz=nnz,
                empty_block_frac=empty_block_frac,
                w_global=w_global, w_typical=w_typical, n_diags=n_diags,
                diag_sym=diag_sym, slot_tile_bytes=slot_tile_bytes)


def route(m: int, n: int, s: dict[str, Any], *,
          expect_structured_x: bool = False, expect_batch: int = 1) -> str:
    """The routing decision alone, from statistics: one of {"dia", "asp",
    "tcsr", "rsell", "binned", "awsp", "sell"}."""
    # banded first: mostly full diagonals whose storage stays within ~4x of
    # the slot formats' 5 B/nnz floor and under 0.8x the dense bytes
    n_diags = s.get("n_diags", 1 << 30)
    eff_diags = (n_diags + 1) // 2 if s.get("diag_sym") else n_diags
    if 0 < n_diags <= 512 and \
            s["nnz"] >= 0.4 * eff_diags * min(m, n) and \
            4 * eff_diags * n <= 4.0 * 5 * s["nnz"] and \
            4 * eff_diags * n <= 0.8 * 4 * m * n:
        return "dia"
    # batch: gather formats pay per (slot, batch) element; route to dense
    # tiles when B x the bytes the B = 1 routing would move passes ~1.3x
    # the dense bytes
    est_sell_bytes = (-(-n // _LANES)) * (-(-m // _LANES)) * \
        round_up(max(s["w_global"], 8), 8) * _LANES * 5
    eff_gather_bytes = min(est_sell_bytes,
                           s.get("slot_tile_bytes") or est_sell_bytes)
    dense_bytes = m * n * 4
    if expect_batch >= 2 and \
            expect_batch * eff_gather_bytes >= 1.3 * dense_bytes:
        return "tcsr" if s["empty_block_frac"] >= 0.4 else "asp"
    if s["density"] > 0.65:
        return "asp"
    if s["empty_block_frac"] >= 0.4:
        return "tcsr"
    skew = s["w_typical"] > 0 and s["w_global"] >= 1.5 * s["w_typical"]
    # flat SELL pays the global width in every window of every column
    pad_ratio = est_sell_bytes / max(5 * s["nnz"], 1)
    if skew or pad_ratio >= 3.0:
        if wide_fits(m, n, max(expect_batch, 1)):
            return "rsell"
        return "binned" if skew else "tcsr"
    return "awsp" if expect_structured_x else "sell"


def sorted_slot_tile_bytes(csr: CsrMatrix) -> int:
    """Per-tile slot demand after the column sort by nnz — what a
    skew-routed RSELL pack stores. O(nnz log nnz)."""
    m, n = csr.shape
    order = np.argsort(-csr.row_nnz, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    r = np.repeat(rank, csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    nt = (m + _LANES - 1) // _LANES
    ck = r * nt + (mi // _LANES)                 # (sorted col, window)
    uk, counts = np.unique(ck, return_counts=True)
    tkey = ((uk // nt) // _LANES) * nt + (uk % nt)
    o2 = np.argsort(tkey, kind="stable")
    tk, cc = tkey[o2], counts[o2]
    if not tk.size:
        return 0
    starts = np.concatenate([[0], np.flatnonzero(np.diff(tk)) + 1])
    w_tile = np.maximum.reduceat(cc, starts)
    return int((-(-w_tile // 8)).sum()) * 8 * 5 * _LANES


def predicted_bytes(m: int, n: int, s: dict[str, Any], kind: str,
                    csr: CsrMatrix | None = None) -> int:
    """Packed-bytes prediction for ``kind`` from statistics alone (no
    packing). Pass ``csr`` to price a skew-routed RSELL pack after its
    column sort; without it the prediction is the unsorted upper bound."""
    if kind == "dia":
        eff = (s["n_diags"] + 1) // 2 if s.get("diag_sym") \
            else s["n_diags"]
        return 4 * eff * n
    if kind == "asp":
        return 4 * m * n
    if kind in ("rsell", "tcsr", "binned"):
        floor = int(s.get("slot_tile_bytes") or 0)
        skew = s["w_typical"] > 0 and \
            s["w_global"] >= 1.5 * s["w_typical"]
        if kind == "rsell" and skew and csr is not None:
            floor = sorted_slot_tile_bytes(csr)
        if kind == "tcsr":
            # each tile costs at most the dense tile, at least its slots
            live = 1.0 - s["empty_block_frac"]
            n_tiles = (round_up(m, _LANES) // _LANES) * \
                (round_up(n, _LANES) // _LANES)
            return int(min(floor, live * n_tiles * _LANES * _LANES * 4))
        return floor
    # flat SELL / AWSP: global width in every window of every column group
    return int((-(-n // _LANES)) * (-(-m // _LANES)) *
               round_up(max(s["w_global"], 8), 8) * _LANES * 5)


def auto_format(a, *, expect_structured_x: bool = False,
                expect_batch: int = 1, stats: dict[str, Any] | None = None,
                device=None):
    """Pack ``a`` (dense numpy or tensor, or a ``CsrMatrix``) into the
    format its statistics call for, on ``device`` (None: the GPU).
    ``expect_batch``: the anticipated SpMM batch. ``stats``: precomputed
    ``matrix_stats``/``matrix_stats_csr``. Raises ``NotImplementedError``
    for a format the port does not have yet. ``auto_format.stats_s`` adds
    up the host seconds from A's copy to the host through its statistics,
    over every call."""
    from tpusparse_torch.formats.awsp import AwspMatrix
    from tpusparse_torch.formats.binned import BinnedSellMatrix
    from tpusparse_torch.formats.dia import DiaMatrix
    from tpusparse_torch.formats.rsell import RsellMatrix
    from tpusparse_torch.formats.sell import SellMatrix
    from tpusparse_torch.formats.tcsr import TcsrMatrix
    from tpusparse_torch.kernels.asp_spmv import AspMatrix

    resolve_device(device)               # fail before packing, not after
    t = time.perf_counter()
    is_csr = isinstance(a, CsrMatrix)
    if not is_csr:
        a = _host_numpy(a)
    s = stats or (matrix_stats_csr(a) if is_csr else matrix_stats(a))
    auto_format.stats_s += time.perf_counter() - t
    m, n = a.shape
    kind = route(m, n, s, expect_structured_x=expect_structured_x,
                 expect_batch=expect_batch)
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"auto_format routes this matrix to {kind!r}, which tpusparse_"
            f"torch does not have yet (ROADMAP.md, {NOT_PORTED[kind]})")
    if kind == "tcsr":
        kw = dict(expect_batch=expect_batch, device=device)
        return TcsrMatrix.from_csr(a, **kw) if is_csr \
            else TcsrMatrix.from_dense(a, **kw)
    cls = {"dia": DiaMatrix, "sell": SellMatrix, "awsp": AwspMatrix,
           "rsell": RsellMatrix, "asp": AspMatrix,
           "binned": BinnedSellMatrix}[kind]
    return cls.from_csr(a, device=device) if is_csr \
        else cls.from_dense(a, device=device)


auto_format.stats_s = 0.0
