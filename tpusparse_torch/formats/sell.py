"""SELL: sliced-ELL with in-window int8 indices — see kernels/sell_spmv.py.

Counterpart of ``tpusparse/formats/sell.py`` with the same packed layout,
bit for bit: A (M, N) -> windows t over M (128 each), column groups j over N
(128 each). ``vals[j, t, s, r]`` = s-th nonzero of output column j*128+r
within window t (zero-padded to W); ``idx[j, t, s, r]`` = its in-window
m-offset (int8, 0..127). Pad slots point at offset 0 with value 0.

Packing runs on the host, through the C++ converter (``native``) for fp32
where it built and in numpy otherwise (the same bits); the packed arrays
then move to the matrix's device as tensors. Storage lanes:

- fp32 (default);
- bf16: packed in fp32, then ``torch.from_numpy(v).to(torch.bfloat16)``
  (round to nearest even, the same bits as ``ml_dtypes``);
- int8 + per-column fp32 scales: symmetric per-output-column quantization,
  dequantized by the kernel once, after the sum.

bf16 and int8 are serving lanes, outside the 1e-3 contract.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix, _host_numpy, segment_ranks
from tpusparse_torch.kernels._build import raw_stream
from tpusparse_torch.kernels.sell_spmv import sell_plan, sell_spmm
from tpusparse_torch.trace import recording, span, spanned
from tpusparse_torch.utils import resolve_device, round_up

_LANES = 128
_SUB = 8
_F32 = torch.float32


def _lane(dtype: Any) -> str | None:
    """Storage lane of a ``dtype`` argument (a torch or numpy dtype or its
    name): None (keep fp32), 'bfloat16' or 'int8'."""
    if dtype is None or isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = np.dtype(dtype).name
    if name in (None, "float32"):
        return None
    if name in ("bfloat16", "int8"):
        return name
    raise ValueError(f"unsupported SELL storage dtype: {dtype!r}")


def _sell_pack_np(a: np.ndarray, w: int | None = None,
                  use_native: bool | None = None) -> dict[str, Any]:
    """Dense (m, n) -> (nb, nt, W, 128) idx/vals in numpy, or through the
    C++ converter (fp32 A; ``use_native`` None: where it built)."""
    m, n = a.shape
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    if (mp, np_) != (m, n):
        a = np.pad(a, ((0, mp - m), (0, np_ - n)))
    nt, nb = mp // _LANES, np_ // _LANES

    if use_native is not False and a.dtype == np.float32:
        from tpusparse_torch import native

        if native.available():
            max_nnz = native.sell_max_window_nnz(a)
            if w is None:
                w = max(round_up(max_nnz, _SUB), _SUB)
            elif max_nnz > w:
                raise ValueError(f"w={w} < max window-column nnz {max_nnz}")
            vals, idx = native.sell_fill(a, w)
            return dict(idx=idx, vals=vals, shape=(m, n), padded=(mp, np_),
                        w=w, nnz=int((a != 0).sum()))
        if use_native:
            raise RuntimeError("native converters requested but unavailable")

    # t4[j, t, r, c] = A[t*128 + c, j*128 + r]: rows are output columns,
    # lanes c are in-window contraction offsets.
    t4 = a.reshape(nt, _LANES, nb, _LANES).transpose(2, 0, 3, 1)
    mask = t4 != 0
    row_nnz = mask.sum(axis=-1)                    # (nb, nt, 128)
    max_nnz = int(row_nnz.max()) if row_nnz.size else 0
    if w is None:
        w = max(round_up(max_nnz, _SUB), _SUB)
    elif max_nnz > w:
        raise ValueError(f"w={w} < max window-column nnz {max_nnz}")

    rank = np.cumsum(mask, axis=-1) - mask
    vals = np.zeros((nb, nt, w, _LANES), dtype=a.dtype)
    idx = np.zeros((nb, nt, w, _LANES), dtype=np.int8)
    jj, tt, rr, cc = np.nonzero(mask)
    wslot = rank[mask]
    vals[jj, tt, wslot, rr] = t4[mask]
    idx[jj, tt, wslot, rr] = cc.astype(np.int8)    # 0..127 fits int8
    return dict(idx=idx, vals=vals, shape=(m, n), padded=(mp, np_),
                w=w, nnz=int(mask.sum()))


def _to_host_tensors(p: dict[str, Any], lane: str | None) -> dict[str, Any]:
    """Apply the storage lane to a numpy pack and wrap its arrays as host
    tensors (``scales`` is None unless the lane is int8)."""
    vals, scales = p["vals"], None
    if lane == "int8":
        amax = np.abs(vals).max(axis=(1, 2))          # (nb, 128) per column
        scales = (np.maximum(amax, 1e-30) / 127.0)
        vals = np.rint(vals / scales[:, None, None, :]).astype(np.int8)
        scales = torch.from_numpy(scales.astype(np.float32))
    vals = torch.from_numpy(vals)
    if lane == "bfloat16":
        vals = vals.to(torch.bfloat16)
    return dict(p, idx=torch.from_numpy(p["idx"]), vals=vals, scales=scales)


def sell_pack(a, w: int | None = None, dtype: Any = None,
              use_native: bool | None = None) -> dict[str, Any]:
    """Dense A (numpy or tensor) -> dict of host tensors ``idx``, ``vals``,
    ``scales`` (None unless int8) and metadata ``shape``, ``padded``, ``w``,
    ``nnz``. ``dtype``: storage lane (None/float32, bfloat16, int8)."""
    return _to_host_tensors(_sell_pack_np(_host_numpy(a), w, use_native),
                            _lane(dtype))


def _sorted_rows(csr: CsrMatrix) -> CsrMatrix:
    """CSR with col_idx ascending within each row (legal CSR does not
    guarantee it; the slot ranking does)."""
    ci = np.asarray(csr.col_idx)
    row_of = np.repeat(np.arange(len(csr.row_ptr) - 1, dtype=np.int64),
                       csr.row_nnz)
    if ci.size == 0 or bool(np.all((row_of[1:] > row_of[:-1])
                                   | (ci[1:] > ci[:-1]))):
        return csr
    order = np.lexsort((ci, row_of))
    return CsrMatrix(shape=csr.shape, row_ptr=csr.row_ptr,
                     col_idx=ci[order], values=np.asarray(csr.values)[order])


def sell_pack_csr(csr: CsrMatrix, w: int | None = None,
                  use_native: bool | None = None) -> dict[str, Any]:
    """Pack straight from a ``CsrMatrix`` (CSR of A.T) without ever
    materializing dense A. Returns the same dict as ``sell_pack``.
    ``use_native``: the C++ packer for fp32 values (None: where it
    built)."""
    m, n = csr.shape
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    nt, nb = mp // _LANES, np_ // _LANES
    csr = _sorted_rows(csr)   # ranking assumes m ascending within each row

    if use_native is not False:
        from tpusparse_torch import native

        if csr.values.dtype == np.float32 and native.available():
            vals, idx, w = native.sell_fill_csr(csr.row_ptr, csr.col_idx,
                                                csr.values, n, nt, w)
            return _to_host_tensors(dict(idx=idx, vals=vals, shape=(m, n),
                                         padded=(mp, np_), w=w,
                                         nnz=int(csr.nnz)), None)
        if use_native:
            raise RuntimeError(
                "native converters requested but unavailable (library "
                f"loaded: {native.available()}, values dtype: "
                f"{csr.values.dtype}; the native packer is fp32-only)")
    jj, t, rank, rr, off, w = _csr_slot_coords(csr, w)
    vals = np.zeros((nb, nt, w, _LANES), dtype=csr.values.dtype)
    idx = np.zeros((nb, nt, w, _LANES), dtype=np.int8)
    vals[jj, t, rank, rr] = csr.values
    idx[jj, t, rank, rr] = off
    return _to_host_tensors(dict(idx=idx, vals=vals, shape=(m, n),
                                 padded=(mp, np_), w=w, nnz=int(csr.nnz)),
                            None)


def _csr_slot_coords(csr: CsrMatrix, w: int | None = None):
    """Per-entry slot coordinates in the (nb, nt, w, 128) SELL layout for a
    row-sorted ``CsrMatrix``: (jj, t, rank, rr, off, w)."""
    n = csr.shape[1]
    row_nnz = csr.row_nnz
    c = np.repeat(np.arange(n, dtype=np.int64), row_nnz)   # output column
    m_idx = csr.col_idx.astype(np.int64)                   # contraction idx
    t = m_idx // _LANES
    off = (m_idx % _LANES).astype(np.int8)
    # entries are sorted by (c, m); rank within each (c, t) run
    rank, _, counts = segment_ranks(c, t)
    max_nnz = int(counts.max()) if counts.size else 0
    if w is None:
        w = max(round_up(max_nnz, _SUB), _SUB)
    elif max_nnz > w:
        raise ValueError(f"w={w} < max window-column nnz {max_nnz}")
    return c // _LANES, t, rank, c % _LANES, off, w


def sell_slot_flat(csr: CsrMatrix, w: int) -> np.ndarray:
    """Flat index into ``vals.ravel()`` of each entry of the row-sorted
    ``csr`` under the SELL layout with width ``w``."""
    m, n = csr.shape
    nt = round_up(m, _LANES) // _LANES
    jj, t, rank, rr, _, w = _csr_slot_coords(csr, w)
    return ((jj * nt + t) * w + rank) * _LANES + rr


def as_input(x, device: torch.device) -> torch.Tensor:
    """An activation (numpy or tensor) as an fp32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class SellMatrix:
    """SELL-packed A held as tensors on one device.

    Its products keep K1's launch plans (``kernels/sell_spmv.py``
    ``SellPlan``) in ``_plans``, one per (batch rows, x's width, device
    index, stream), built on the first product of that key. A plan holds
    the ``idx``, ``vals`` and ``scales`` it was built from: one of them
    replaced by another tensor makes the next product of the key build
    anew (in-place updates keep the plan's pointers valid)."""

    def __init__(self, idx: torch.Tensor, vals: torch.Tensor, shape, padded,
                 w: int, nnz: int, scales: torch.Tensor | None = None):
        self.idx = idx                 # (nb, nt, W, 128) int8
        self.vals = vals               # (nb, nt, W, 128) fp32 / bf16 / int8
        self.shape = tuple(shape)
        self.padded = tuple(padded)
        self.w = w
        self.nnz = nnz
        self.scales = scales           # (nb, 128) fp32, int8 storage only
        self._plans: dict[tuple[int, int, int, int], Any] = {}

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def __repr__(self) -> str:
        return (f"SellMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"w={self.w}, dtype={self.vals.dtype}, device={self.device}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def _from_pack(cls, p: dict[str, Any], device) -> "SellMatrix":
        dev = resolve_device(device)
        scales = None if p["scales"] is None else p["scales"].to(dev)
        return cls(p["idx"].to(dev), p["vals"].to(dev), p["shape"],
                   p["padded"], p["w"], p["nnz"], scales=scales)

    @classmethod
    def from_dense(cls, a, w: int | None = None, dtype: Any = None,
                   device=None) -> "SellMatrix":
        """``dtype=torch.bfloat16``: half-size value storage; ``'int8'``:
        2 bytes/slot with per-column scales. ``device=None`` is the GPU."""
        resolve_device(device)           # fail before packing, not after
        return cls._from_pack(sell_pack(a, w=w, dtype=dtype), device)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, w: int | None = None,
                 device=None) -> "SellMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        resolve_device(device)
        return cls._from_pack(sell_pack_csr(csr, w=w), device)

    def device_bytes(self) -> int:
        total = self.vals.numel() * (self.vals.element_size() + 1)
        if self.scales is not None:
            total += self.scales.numel() * 4
        return total

    def read_bytes(self) -> int:
        """The bytes a product must read of the pack: the live values with
        their one-byte indices (and the scales of int8 storage). The zero
        pad slots up to each window's width W need not be read."""
        total = self.nnz * (self.vals.element_size() + 1)
        if self.scales is not None:
            total += self.scales.numel() * 4
        return total

    def to_dense(self) -> torch.Tensor:
        """Dense A on the host; int8 storage dequantizes to fp32."""
        idx, vals = self.idx.cpu(), self.vals.cpu()
        mp, np_ = self.padded
        out_dtype = torch.float32 if self.scales is not None else vals.dtype
        a = torch.zeros((mp, np_), dtype=out_dtype)
        jj, tt, ww, rr = torch.nonzero(vals, as_tuple=True)
        v = vals[jj, tt, ww, rr]
        if self.scales is not None:                    # dequantize int8
            v = v.float() * self.scales.cpu()[jj, rr]
        cc = idx[jj, tt, ww, rr].long()
        a[tt * _LANES + cc, jj * _LANES + rr] = v
        return a[:self.shape[0], :self.shape[1]]

    def _plan(self, batch: int, ldx: int, index: int):
        """The plan of key (batch, ldx, device ``index``, current stream)
        if one was built from the matrix's present tensors, else None."""
        plan = self._plans.get((batch, ldx, index, raw_stream(index)
                                if index >= 0 else 0))
        if plan is None or plan.vals is not self.vals \
                or plan.idx is not self.idx or plan.scales is not self.scales:
            return None
        sell_plan.hits += 1
        return plan

    def _run(self, x2d: torch.Tensor, vec: bool = False) -> torch.Tensor:
        """``x2d`` on the matrix's device -> (B, n), or (n,) where ``vec``."""
        x2d = x2d.contiguous()
        if x2d.ndim != 2:       # sell_spmm raises (the plain version runs
            y = sell_spmm(self.idx, self.vals, x2d,          # on the CPU)
                          scales=self.scales, n=self.shape[1])
            return y[0] if vec else y
        batch, ldx = x2d.shape
        index = x2d.get_device()
        plan = self._plan(batch, ldx, index)
        if plan is None:
            key = (batch, ldx, index, raw_stream(index) if index >= 0 else 0)
            plan = sell_plan(self.idx, self.vals, x2d, scales=self.scales,
                             n=self.shape[1], stream=key[3])
            if key in self._plans:      # its plan held replaced tensors
                sell_plan.rebuilds += 1
            self._plans[key] = plan
        # no padding to the packed rows: the kernel reads them as zero
        return plan.run(x2d, vec)

    def spmv(self, x) -> torch.Tensor:
        """x: (m,) -> y = x @ A, (n,)."""
        # the span's gate inline: a B = 1 product is host-bound
        if recording():
            with span("tps.spmv"):
                return self._spmv(x)
        return self._spmv(x)

    def _spmv(self, x) -> torch.Tensor:
        # planned as it is: a contiguous fp32 vector on the card
        if type(x) is torch.Tensor and x.is_cuda and x.dtype is _F32 \
                and x.ndim == 1 and x.is_contiguous():
            plan = self._plan(1, x.shape[0], x.get_device())
            if plan is not None:
                return plan.run(x, True)
        return self._run(as_input(x, self.device)[None, :], True)

    @spanned("tps.spmm")
    def spmm(self, x) -> torch.Tensor:
        """x: (b, m) -> Y = X @ A, (b, n)."""
        if type(x) is torch.Tensor and x.is_cuda and x.dtype is _F32 \
                and x.ndim == 2 and x.is_contiguous():
            plan = self._plan(x.shape[0], x.shape[1], x.get_device())
            if plan is not None:
                return plan.run(x)
        return self._run(as_input(x, self.device))
