"""BELL: bitmap blocked-ELL — see kernels/bell_spmv.py (K12).

Counterpart of ``tpusparse/formats/bell.py`` with the same packed layout,
bit for bit. Blocks are BM deep along the contraction dim and 128 output
columns wide. For output group j and contraction block i:

- ``bitmap[j, i]`` (128, BM/32) uint32: the bit of in-block position l of
  output column r sits in word ``l % nwords`` at bit ``l // nwords``
  (nwords = BM/32). This interleaved order is the TPU kernel's, kept so
  packs compare array for array; the rank is still counted in natural
  order of l.
- ``carries[j, i]`` (128, BM/128) int32: the number of nonzeros before each
  128-position m-tile (the TPU kernel's rank carry; the CUDA kernel ranks
  a whole column in one warp and does not read them).
- ``vals[j, i]`` (128, W): each column's nonzeros packed to the left and
  zero-padded to W, the widest block-column rounded up to 128.

``bell_pack`` takes the C++ converter (``native``) for an fp32 A's bitmap
where it built, as the JAX packer does, and ``_mask_to_words`` otherwise:
both give the same words.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix, _host_numpy, segment_ranks
from tpusparse_torch.formats.sell import _sorted_rows, as_input
from tpusparse_torch.trace import spanned
from tpusparse_torch.utils import resolve_device, round_up

_LANES = 128


def _mask_to_words(mask: np.ndarray, block_m: int) -> np.ndarray:
    """(..., BM) bool -> (..., BM/32) uint32 in the interleaved bit order:
    position l -> word l % nwords, bit l // nwords."""
    nwords = block_m // 32
    bits = mask.reshape(*mask.shape[:-1], 32, nwords)  # l = b*nwords + w
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))[:, None]
    return (bits * weights).sum(axis=-2).astype(np.uint32)


def _words_to_mask(words: np.ndarray, block_m: int) -> np.ndarray:
    bits = (words[..., None, :] >> np.arange(32, dtype=np.uint32)[:, None]) & 1
    return bits.reshape(*words.shape[:-1], block_m).astype(bool)


def bell_pack(a, block_m: int = 512, w: int | None = None) -> dict[str, Any]:
    """Dense (M, N) -> numpy bitmap (nb, mb, 128, BM/32) uint32, carries
    (nb, mb, 128, BM/128) int32 and vals (nb, mb, 128, W), with metadata."""
    a = _host_numpy(a)
    m, n = a.shape
    block_m = min(block_m, round_up(m, _LANES))
    mp, np_ = round_up(m, block_m), round_up(n, _LANES)
    if (mp, np_) != (m, n):
        a = np.pad(a, ((0, mp - m), (0, np_ - n)))
    mb, nb = mp // block_m, np_ // _LANES

    # t[j, i, r, c] = A[i*BM + c, j*128 + r]
    t = a.reshape(mb, block_m, nb, _LANES).transpose(2, 0, 3, 1)
    mask = t != 0
    row_nnz = mask.sum(axis=-1)                   # (nb, mb, 128)
    max_nnz = int(row_nnz.max()) if row_nnz.size else 0
    if w is None:
        w = max(round_up(max_nnz, _LANES), _LANES)
    elif max_nnz > w:
        raise ValueError(f"w={w} < max block-column nnz {max_nnz}")

    rank = np.cumsum(mask, axis=-1) - mask        # exclusive rank
    vals = np.zeros((nb, mb, _LANES, w), dtype=a.dtype)
    jj, ii, rr, _ = np.nonzero(mask)
    vals[jj, ii, rr, rank[mask]] = t[mask]
    nmt = block_m // _LANES
    carries = rank.reshape(nb, mb, _LANES, nmt, _LANES)[..., 0] \
        .astype(np.int32)
    bitmap = None
    if a.dtype == np.float32:
        from tpusparse_torch import native

        bitmap = native.bell_bitmap(a, block_m)       # None: unavailable
    if bitmap is None:
        bitmap = _mask_to_words(mask, block_m)
    return dict(bitmap=bitmap, carries=carries, vals=vals, shape=(m, n),
                padded=(mp, np_), block_m=block_m, w=w, nnz=int(mask.sum()))


def bell_pack_csr(csr: CsrMatrix, block_m: int = 512,
                  w: int | None = None) -> dict[str, Any]:
    """Pack from ``CsrMatrix`` without materializing dense A (the bitmap is
    still M*N/8 bytes). Assumes no duplicate positions."""
    m, n = csr.shape
    block_m = min(block_m, round_up(m, _LANES))
    mp, np_ = round_up(m, block_m), round_up(n, _LANES)
    mb, nb = mp // block_m, np_ // _LANES
    csr = _sorted_rows(csr)       # the rank below needs m ascending per row

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    jj, rr = r // _LANES, r % _LANES
    ii, ll = mi // block_m, mi % block_m

    rank, _, counts = segment_ranks(r, ii)
    max_nnz = int(counts.max()) if counts.size else 0
    if w is None:
        w = max(round_up(max_nnz, _LANES), _LANES)
    elif max_nnz > w:
        raise ValueError(f"w={w} < max block-column nnz {max_nnz}")

    vals = np.zeros((nb, mb, _LANES, w), dtype=csr.values.dtype)
    vals[jj, ii, rr, rank] = csr.values
    nwords = block_m // 32
    bitmap = np.zeros((nb, mb, _LANES, nwords), dtype=np.uint32)
    np.bitwise_or.at(
        bitmap, (jj, ii, rr, ll % nwords),
        (np.uint32(1) << (ll // nwords).astype(np.uint32)))
    nmt = block_m // _LANES
    cnt = np.zeros((nb, mb, _LANES, nmt), dtype=np.int32)
    np.add.at(cnt, (jj, ii, rr, ll // _LANES), 1)
    carries = np.cumsum(cnt, axis=-1) - cnt
    return dict(bitmap=bitmap, carries=carries, vals=vals, shape=(m, n),
                padded=(mp, np_), block_m=block_m, w=w, nnz=int(csr.nnz))


class BellMatrix:
    """BELL-packed A held as tensors on one device. The bitmap is stored as
    int32 (torch has no uint32 arithmetic on every device); the bits are
    the JAX pack's."""

    def __init__(self, bitmap: torch.Tensor, carries: torch.Tensor,
                 vals: torch.Tensor, shape, padded, block_m: int, w: int,
                 nnz: int):
        self.bitmap = bitmap          # (nb, mb, 128, BM/32) int32 bits
        self.carries = carries        # (nb, mb, 128, BM/128) int32 ranks
        self.vals = vals              # (nb, mb, 128, W) fp32
        self.shape = tuple(shape)
        self.padded = tuple(padded)
        self.block_m = block_m
        self.w = w
        self.nnz = nnz

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def __repr__(self) -> str:
        return (f"BellMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"block_m={self.block_m}, w={self.w}, device={self.device}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def _from_pack(cls, p: dict[str, Any], device) -> "BellMatrix":
        dev = resolve_device(device)

        def tensor(v):      # the dense packer's words come out transposed
            return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

        return cls(tensor(p["bitmap"].view(np.int32)), tensor(p["carries"]),
                   tensor(p["vals"]), p["shape"], p["padded"], p["block_m"],
                   p["w"], p["nnz"])

    @classmethod
    def from_dense(cls, a, block_m: int = 512, w: int | None = None,
                   device=None) -> "BellMatrix":
        """Dense A (numpy or tensor) on ``device`` (None: the GPU)."""
        resolve_device(device)           # fail before packing, not after
        return cls._from_pack(bell_pack(a, block_m=block_m, w=w), device)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, block_m: int = 512,
                 w: int | None = None, device=None) -> "BellMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        resolve_device(device)
        return cls._from_pack(bell_pack_csr(csr, block_m=block_m, w=w),
                              device)

    def words(self) -> np.ndarray:
        """The bitmap as the JAX pack's uint32 array, on the host."""
        return self.bitmap.cpu().numpy().view(np.uint32)

    def device_bytes(self) -> int:
        """Every stored byte: bitmap, carries and values with their pads
        (the JAX package's meaning)."""
        return (self.bitmap.numel() + self.carries.numel()) * 4 + \
            self.vals.numel() * self.vals.element_size()

    def read_bytes(self) -> int:
        """The bytes a product must read: the bitmap and the live values.
        Pads past each column's count are zero and need not be read, and
        the carries are not needed to rank a whole column."""
        return self.bitmap.numel() * 4 + self.nnz * self.vals.element_size()

    def to_dense(self) -> torch.Tensor:
        """Dense A on the host."""
        vals = self.vals.cpu().numpy()
        nb, mb = vals.shape[:2]
        mask = _words_to_mask(self.words(), self.block_m)
        rank = np.cumsum(mask, axis=-1) - mask
        t = np.zeros((nb, mb, _LANES, self.block_m), dtype=vals.dtype)
        jj, ii, rr, _ = np.nonzero(mask)
        t[mask] = vals[jj, ii, rr, rank[mask]]
        mp, np_ = self.padded
        a = t.transpose(1, 3, 0, 2).reshape(mp, np_)
        return torch.from_numpy(np.ascontiguousarray(
            a[:self.shape[0], :self.shape[1]]))

    def _run(self, x2d: torch.Tensor) -> torch.Tensor:
        from tpusparse_torch.kernels.bell_spmv import bell_spmm

        if x2d.ndim != 2 or x2d.shape[1] > self.padded[0]:
            raise ValueError(f"x must be (b, <={self.padded[0]}), got "
                             f"{tuple(x2d.shape)}")
        # no padding to the packed rows: the kernel reads them as zero
        return bell_spmm(self.bitmap, self.vals, x2d.contiguous(),
                         block_m=self.block_m, n=self.shape[1])

    @spanned("tps.spmv")
    def spmv(self, x) -> torch.Tensor:
        """x: (m,) -> y = x @ A, (n,)."""
        return self._run(as_input(x, self.device)[None, :])[0]

    @spanned("tps.spmm")
    def spmm(self, x) -> torch.Tensor:
        """x: (b, m) -> Y = X @ A, (b, n)."""
        return self._run(as_input(x, self.device))
