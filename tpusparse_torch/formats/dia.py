"""DIA: diagonal-offset storage for banded matrices — see
kernels/dia_spmv.py (K8).

Counterpart of ``tpusparse/formats/dia.py`` with the same pack, bit for bit:
k diagonals of A as (k, n) fp32 rows, ``offsets[i] = m_index - out_index``,

    y[c] = sum_i vals[i, c] * x[c + offsets[i]].

A bitwise-symmetric square operator stores only its ``d >= 0`` diagonals
(``sym``); the mirror ``vals_{-d}[c] = vals_d[c - d]`` is read from the same
row at a shifted position. Packing runs on the host in numpy.

``DiaMatrix.spmv`` runs K8 where the JAX package runs its kernel (square,
``fits``, not ``xla_only``), with K8's plan built once per matrix
(``DiaMatrix.plan``). Everywhere else, and for ``spmm`` always, it
runs the shifted elementwise form below: the counterpart of the plain XLA
code the JAX package runs there outside any Pallas kernel. That form is
part of the format, not K8's plain version (``dia_spmv_plain``).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.sell import as_input
from tpusparse_torch.kernels.dia_spmv import (DiaPlan, dia_plan, dia_spmv,
                                              fits)
from tpusparse_torch.utils import resolve_device


def dia_pack_csr(csr: CsrMatrix, max_diags: int = 512,
                 symmetric: bool | str = "auto") -> dict[str, Any]:
    """Pack from ``CsrMatrix`` (CSR of A.T) in O(nnz + k*n) into a numpy
    pack: ``offsets`` (tuple), ``vals`` (k, n) fp32, ``shape``, ``nnz``,
    ``sym``.

    Raises if the matrix touches more than ``max_diags`` distinct diagonals.
    ``symmetric="auto"`` keeps only the ``d >= 0`` diagonals of a bitwise-
    symmetric square operator; ``False`` forces full storage; ``True``
    asserts symmetry and raises if it does not hold bitwise. Duplicate
    positions sum."""
    m, n = csr.shape
    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    d = mi - r
    offsets = np.unique(d)
    if offsets.size > max_diags:
        raise ValueError(
            f"{offsets.size} distinct diagonals > max_diags={max_diags}; "
            "DIA suits banded matrices — use auto_format for routing")
    vals = np.zeros((max(offsets.size, 1), n), dtype=np.float32)
    if d.size:
        slot = np.searchsorted(offsets, d)
        np.add.at(vals, (slot, r), csr.values.astype(np.float32))

    sym = False
    if symmetric and m == n:
        if not offsets.size:
            sym = True                   # empty operator: trivially sym
        else:
            neg = offsets[offsets < 0]
            pos = set(int(v) for v in offsets[offsets > 0])
            mirrored = all(-int(v) in pos for v in neg) and \
                len(neg) == len(pos)
            if mirrored:
                off_l = [int(v) for v in offsets]
                sym = all(
                    np.array_equal(vals[off_l.index(-dd)][dd:],
                                   vals[off_l.index(dd)][:n - dd])
                    and not vals[off_l.index(-dd)][:dd].any()
                    for dd in sorted(pos))
            if sym:
                keep = offsets >= 0
                offsets = offsets[keep]
                vals = vals[keep]
    if symmetric is True and not sym:
        raise ValueError(
            "symmetric=True but the matrix is not square bitwise-"
            "symmetric in DIA layout" if m == n else
            f"symmetric=True needs a square operator, got {m}x{n}")
    return dict(offsets=tuple(int(v) for v in offsets), vals=vals,
                shape=(m, n), nnz=int(csr.nnz), sym=sym)


def _shift_right(v: torch.Tensor, d: int) -> torch.Tensor:
    """``v`` moved d places up the index, zero-filled: out[c] = v[c - d]."""
    return F.pad(v, (d, 0))[:v.shape[0]]


class DiaMatrix:
    """k diagonals of A as (k, n) fp32 rows on one device;
    ``offsets[i] = m_index - out_index``. ``xla_only`` keeps ``spmv`` on the
    shifted form (the JAX package sets it for its sharded solvers)."""

    def __init__(self, offsets: tuple, vals: torch.Tensor, shape, nnz: int,
                 sym: bool = False, xla_only: bool = False):
        self.offsets = tuple(int(d) for d in offsets)
        self.vals = vals                # (k, n) fp32
        self.shape = tuple(shape)
        self.nnz = nnz
        self.sym = bool(sym)
        self.xla_only = bool(xla_only)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @functools.cached_property
    def plan(self) -> DiaPlan:
        """K8's plan (its tile, terms and staged windows), built once."""
        return dia_plan(self.offsets, self.sym)

    def __repr__(self) -> str:
        return (f"DiaMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"diags={len(self.offsets)}{'|sym' if self.sym else ''}, "
                f"device={self.device}, {self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_csr(cls, csr: CsrMatrix, max_diags: int = 512,
                 symmetric: bool | str = "auto", device=None) -> "DiaMatrix":
        """Pack from ``CsrMatrix`` on ``device`` (None: the GPU)."""
        dev = resolve_device(device)     # fail before packing, not after
        p = dia_pack_csr(csr, max_diags=max_diags, symmetric=symmetric)
        return cls(p["offsets"], torch.from_numpy(p["vals"]).to(dev),
                   p["shape"], p["nnz"], sym=p["sym"])

    @classmethod
    def from_dense(cls, a, max_diags: int = 512,
                   symmetric: bool | str = "auto", device=None) -> "DiaMatrix":
        """Dense A (numpy or tensor) on ``device`` (None: the GPU)."""
        resolve_device(device)
        return cls.from_csr(CsrMatrix.from_dense(a), max_diags=max_diags,
                            symmetric=symmetric, device=device)

    def device_bytes(self) -> int:
        return self.vals.numel() * 4

    def desym(self) -> "DiaMatrix":
        """Full storage from symmetric storage (itself when already full):
        the mirror row of d > 0 is ``vals_{-d}[c] = vals_d[c - d]``."""
        if not self.sym:
            return self
        rows = {d: self.vals[i] for i, d in enumerate(self.offsets)}
        for i, d in enumerate(self.offsets):
            if d > 0:
                rows[-d] = _shift_right(self.vals[i], d)
        offs = sorted(rows)
        return DiaMatrix(tuple(offs), torch.stack([rows[d] for d in offs]),
                         self.shape, self.nnz, sym=False,
                         xla_only=self.xla_only)

    def to_dense(self) -> torch.Tensor:
        """Dense A on the host."""
        m, n = self.shape
        a = np.zeros((m, n), dtype=np.float32)
        vals = self.vals.cpu().numpy()
        for i, d in enumerate(self.offsets):
            c = np.arange(max(0, -d), min(n, m - d), dtype=np.int64)
            a[c + d, c] = vals[i, c]
            if self.sym and d > 0:
                a[c, c + d] = vals[i, c]
        return torch.from_numpy(a)

    def _x_pad(self) -> tuple[int, int]:
        """Zeros to put before and after x so every shifted read is in
        range."""
        m, n = self.shape
        dmin = min(self.offsets) if self.offsets else 0
        dmax = max(self.offsets) if self.offsets else 0
        if self.sym:
            dmin = min(dmin, -dmax)
        return max(0, -dmin), max(0, dmax + n - m)

    def _shifted(self, x2d: torch.Tensor) -> torch.Tensor:
        """The shifted elementwise form, x (b, m) -> (b, n): k statically
        shifted multiply-adds (and the mirrors when ``sym``)."""
        m, n = self.shape
        if x2d.ndim != 2 or x2d.shape[1] != m:
            raise ValueError(f"x must be (b, {m}), got {tuple(x2d.shape)}")
        lo, hi = self._x_pad()
        xp = F.pad(x2d, (lo, hi))
        y = torch.zeros((x2d.shape[0], n), dtype=torch.float32,
                        device=x2d.device)
        for i, d in enumerate(self.offsets):
            y = y + self.vals[i][None, :] * xp[:, d + lo:d + lo + n]
            if self.sym and d > 0:
                vp = _shift_right(self.vals[i], d)
                y = y + vp[None, :] * xp[:, lo - d:lo - d + n]
        return y

    def spmv(self, x) -> torch.Tensor:
        """x: (m,) -> y = x @ A, (n,). K8 for a square operator that
        ``fits`` the kernel, the shifted form otherwise; a 2-D x goes to
        ``spmm``."""
        x = as_input(x, self.device)
        if x.ndim != 1:
            return self.spmm(x)
        m, n = self.shape
        if m == n and not self.xla_only and fits(self.offsets, self.sym, n):
            return dia_spmv(self.offsets, self.vals, x.contiguous(),
                            sym=self.sym, n=n, plan=self.plan)
        return self._shifted(x[None, :])[0]

    def spmm(self, x) -> torch.Tensor:
        """x: (b, m) -> Y = X @ A, (b, n), through the shifted form."""
        return self._shifted(as_input(x, self.device))
