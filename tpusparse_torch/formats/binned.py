"""Binned SELL: sorted column groups with per-bucket padding widths.

Counterpart of ``tpusparse/formats/binned.py`` with the same packs bit for
bit. Output columns are sorted by nnz (stable), grouped into 128-column
groups, and each group goes to the bucket whose SELL width is the smallest
level (``_pick_levels``: quantiles of the groups' width demand) that covers
its widest window. Each bucket is a SELL pack run by K1
(``kernels/sell_spmv.py``); the buckets' outputs are concatenated and the
column order is undone by K5 (``kernels/permute.py``), whose source lanes
come from the JAX package's permute plan. On a power-law matrix the dense
head pays a wide bucket while the long tail pays a narrow one.

The JAX package sizes each bucket's Pallas grid with ``tune.sell_geometry``
(TPU step geometry); K1 picks its own launch shape, so that is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.formats.csr import (CsrMatrix, _host_numpy,
                                         col_window_widths, csr_rows_subset)
from tpusparse_torch.formats.sell import (_sell_pack_np, as_input,
                                          sell_pack_csr)
from tpusparse_torch.kernels.permute import (permute_columns, permute_plan,
                                             source_lanes)
from tpusparse_torch.utils import resolve_device, round_up

_LANES = 128


def _pick_levels(group_w: np.ndarray, max_buckets: int = 3) -> list[int]:
    """Width levels (slots per 128-window) from the quantiles of the
    groups' demand: few, large buckets, each one K1 launch."""
    qs = (0.5, 0.85, 1.0)[-max_buckets:]
    levels = sorted({max(round_up(int(np.quantile(group_w, q)), 8), 8)
                     for q in qs})
    if levels[-1] < group_w.max():        # guarantee coverage
        levels[-1] = int(round_up(int(group_w.max()), 8))
    return levels


def _bucket(group_w: np.ndarray, pack) -> tuple[list, tuple, list]:
    """Each width level's groups packed by ``pack(sorted columns, w)``:
    (buckets, widths, the sorted columns of each bucket)."""
    lv = _pick_levels(group_w)
    need = np.array(lv).searchsorted(group_w, side="left")
    buckets, widths, order = [], [], []
    for li, level in enumerate(lv):
        groups = np.nonzero(need == li)[0]
        if groups.size == 0:
            continue
        cols = (groups[:, None] * _LANES + np.arange(_LANES)[None, :]).ravel()
        buckets.append(pack(cols, int(level)))
        widths.append(int(level))
        order.append(cols)
    return buckets, tuple(widths), order


def _finish(perm: np.ndarray, order: list, np_: int, n: int):
    """inv_perm (n,) and the JAX-layout permute plan: y_concat is in
    (bucket, group) order over sorted columns; undo both."""
    order = np.concatenate(order) if order else np.arange(0)
    final_perm = perm[order]                   # output col of y slot k
    inv_perm = np.empty(np_, dtype=np.int32)
    inv_perm[final_perm] = np.arange(np_, dtype=np.int32)
    pp = permute_plan(inv_perm)
    return inv_perm[:n], (pp["oidx"], pp["oh"])


def binned_pack(a) -> dict:
    """Dense A (numpy or tensor) -> numpy buckets (``idx``/``vals`` each),
    ``inv_perm``, ``perm_plan``, ``shape``, ``nnz`` and ``widths``."""
    a = _host_numpy(a)
    m, n = a.shape
    np_ = round_up(n, _LANES)
    if np_ != n:
        a = np.pad(a, ((0, 0), (0, np_ - n)))
    col_nnz = (a != 0).sum(axis=0)
    perm = np.argsort(-col_nnz, kind="stable").astype(np.int32)
    a_sorted = a[:, perm]

    nb = np_ // _LANES
    # width demand per column group: the max nnz of any column within any
    # 128-row window of that group
    mp = round_up(m, _LANES)
    ap = np.pad(a_sorted, ((0, mp - m), (0, 0)))
    win = (ap.reshape(mp // _LANES, _LANES, np_) != 0).sum(axis=1)
    group_w = win.reshape(mp // _LANES, nb, _LANES).max(axis=(0, 2))

    def pack(cols, w):
        p = _sell_pack_np(a_sorted[:, cols], w=w)
        return dict(idx=p["idx"], vals=p["vals"])

    buckets, widths, order = _bucket(group_w, pack)
    inv_perm, plan = _finish(perm, order, np_, n)
    return dict(buckets=buckets, inv_perm=inv_perm, perm_plan=plan,
                shape=(m, n), nnz=int((a != 0).sum()), widths=widths)


def binned_pack_csr(csr: CsrMatrix) -> dict:
    """The same pack from ``CsrMatrix`` without materializing dense A: the
    column sort is a CSR row-subset gather (columns of A are this CSR's
    rows) and each bucket is packed by ``sell_pack_csr``."""
    m, n = csr.shape
    np_ = round_up(n, _LANES)
    col_nnz = np.zeros(np_, dtype=np.int64)
    col_nnz[:n] = csr.row_nnz
    perm = np.argsort(-col_nnz, kind="stable").astype(np.int32)

    col_w = np.zeros(np_, dtype=np.int64)
    col_w[:n] = col_window_widths(csr)
    nb = np_ // _LANES
    group_w = col_w[perm].reshape(nb, _LANES).max(axis=1)

    def pack(cols, w):
        p = sell_pack_csr(csr_rows_subset(csr, perm[cols]), w=w)
        return dict(idx=p["idx"].numpy(), vals=p["vals"].numpy())

    buckets, widths, order = _bucket(group_w, pack)
    inv_perm, plan = _finish(perm, order, np_, n)
    return dict(buckets=buckets, inv_perm=inv_perm, perm_plan=plan,
                shape=(m, n), nnz=int(csr.nnz), widths=widths)


class BinnedSellMatrix:
    """Binned SELL held as tensors on one device: one SELL pack per width
    bucket, and K5's source lanes for the unpermute."""

    def __init__(self, buckets: list[dict], inv_perm: np.ndarray,
                 perm_plan: tuple, shape, nnz: int, widths: tuple):
        self.buckets = buckets          # [{"idx", "vals"}], SELL packs
        self.inv_perm = inv_perm        # (n,) int32 numpy: undo the sort
        self.perm_plan = perm_plan      # the JAX-layout (oidx, oh), numpy
        self.shape = tuple(shape)
        self.nnz = nnz
        self.widths = tuple(widths)
        # K5 reads one int32 source lane per output column
        self.perm_src = torch.from_numpy(
            source_lanes(*perm_plan, self.shape[1])).to(self.device)

    @property
    def device(self) -> torch.device:
        return self.buckets[0]["vals"].device

    def __repr__(self) -> str:
        return (f"BinnedSellMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"widths={self.widths}, device={self.device}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def _from_pack(cls, p: dict, device) -> "BinnedSellMatrix":
        dev = resolve_device(device)
        buckets = [{k: torch.from_numpy(b[k]).to(dev) for k in ("idx", "vals")}
                   for b in p["buckets"]]
        return cls(buckets, p["inv_perm"], p["perm_plan"], p["shape"],
                   p["nnz"], p["widths"])

    @classmethod
    def from_dense(cls, a, device=None) -> "BinnedSellMatrix":
        """Dense A (numpy or tensor) on ``device`` (None: the GPU)."""
        resolve_device(device)           # fail before packing, not after
        return cls._from_pack(binned_pack(a), device)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, device=None) -> "BinnedSellMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        resolve_device(device)
        return cls._from_pack(binned_pack_csr(csr), device)

    def device_bytes(self) -> int:
        return sum(b["vals"].numel() * (b["vals"].element_size() + 1)
                   for b in self.buckets)

    def to_dense(self) -> torch.Tensor:
        """Dense A on the host."""
        m, n = self.shape
        cols = []
        for b in self.buckets:
            idx, vals = b["idx"].cpu(), b["vals"].cpu()
            nbk, nt = vals.shape[:2]
            d = torch.zeros((nt * _LANES, nbk * _LANES), dtype=vals.dtype)
            jj, tt, ww, rr = torch.nonzero(vals, as_tuple=True)
            d[tt * _LANES + idx[jj, tt, ww, rr].long(), jj * _LANES + rr] = \
                vals[jj, tt, ww, rr]
            cols.append(d[:m])
        dense_sorted = torch.cat(cols, dim=1) if cols else \
            torch.zeros((m, 0), dtype=torch.float32)
        return dense_sorted[:, torch.from_numpy(self.inv_perm).long()]

    def _run(self, x2d: torch.Tensor) -> torch.Tensor:
        from tpusparse_torch.kernels.sell_spmv import sell_spmm

        x2d = x2d.contiguous()
        # no padding to the packed rows: K1 reads them as zero
        parts = [sell_spmm(b["idx"], b["vals"], x2d) for b in self.buckets]
        return permute_columns(torch.cat(parts, dim=1), self.perm_src)

    def spmv(self, x) -> torch.Tensor:
        """x: (m,) -> y = x @ A, (n,)."""
        return self._run(as_input(x, self.device)[None, :])[0]

    def spmm(self, x) -> torch.Tensor:
        """x: (b, m) -> Y = X @ A, (b, n)."""
        return self._run(as_input(x, self.device))
