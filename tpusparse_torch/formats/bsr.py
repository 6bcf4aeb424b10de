"""BSR: block-sparse rows of dense (block_m x 128) tiles — see
kernels/bsr_spmv.py (K6).

Counterpart of ``tpusparse/formats/bsr.py`` with the same pack, bit for bit:
the kept tiles of A, each stored whole, with their (bi, bj) coordinates (bi
over the contraction rows in block_m steps, bj over the output columns in
128 steps). Empty tiles store nothing. Packing runs on the host in numpy;
``BsrMatrix`` holds the arrays as tensors on one device, with K6's work plan
built once per pack.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix, _host_numpy
from tpusparse_torch.formats.sell import as_input
from tpusparse_torch.kernels.bsr_spmv import bsr_plans, bsr_spmm
from tpusparse_torch.trace import spanned
from tpusparse_torch.utils import resolve_device, round_up

_LANES = 128


def bsr_pack(a, block_m: int = 128) -> dict[str, Any]:
    """Dense A (numpy or tensor) -> numpy pack: ``bi``, ``bj``, ``blocks``
    and metadata ``shape``, ``padded``, ``block_m``, ``nnz``, ``n_real``."""
    a = _host_numpy(a)
    m, n = a.shape
    mp, np_ = round_up(m, block_m), round_up(n, _LANES)
    if (mp, np_) != (m, n):
        a = np.pad(a, ((0, mp - m), (0, np_ - n)))
    mb, nb = mp // block_m, np_ // _LANES

    tiles = a.reshape(mb, block_m, nb, _LANES).transpose(0, 2, 1, 3)
    nz = tiles.any(axis=(2, 3))                       # (mb, nb)
    ii, jj = np.nonzero(nz)
    n_real = int(ii.size)
    ii, jj, blocks = _canonicalize_blocks(
        ii, jj, lambda order: tiles[ii[order], jj[order]], nb, block_m,
        tiles.dtype)
    return dict(bi=ii.astype(np.int32), bj=jj.astype(np.int32),
                blocks=np.ascontiguousarray(blocks), shape=(m, n),
                padded=(mp, np_), block_m=block_m,
                nnz=int((a != 0).sum()), n_real=n_real)


def bsr_pack_csr(csr: CsrMatrix, block_m: int = 128) -> dict[str, Any]:
    """Pack straight from ``CsrMatrix`` (CSR of A.T): memory touched is
    O(nnz + kept blocks), never the (m, n) dense array. Duplicate positions
    sum, as ``CsrMatrix.to_dense`` does."""
    m, n = csr.shape
    mp, np_ = round_up(m, block_m), round_up(n, _LANES)
    nb = np_ // _LANES

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)  # output col
    mi = csr.col_idx.astype(np.int64)
    key = (mi // block_m) * nb + (r // _LANES)
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((uniq.size, block_m, _LANES), csr.values.dtype)
    np.add.at(blocks, (inv, mi % block_m, r % _LANES), csr.values)
    nnz = int((blocks != 0).sum())
    n_real = int(uniq.size)
    ii, jj, blocks = _canonicalize_blocks(
        (uniq // nb), uniq % nb, lambda order: blocks[order], nb, block_m,
        blocks.dtype)
    return dict(bi=ii.astype(np.int32), bj=jj.astype(np.int32),
                blocks=np.ascontiguousarray(blocks), shape=(m, n),
                padded=(mp, np_), block_m=block_m, nnz=nnz, n_real=n_real)


def bsr_pack_blocks(m: int, n: int, bi, bj, blocks) -> dict[str, Any]:
    """scipy-BSR-style ingestion: block (bi[k], bj[k]) = blocks[k], each
    (block_m x 128). Returns the numpy pack."""
    bi = np.asarray(bi, dtype=np.int32)
    bj = np.asarray(bj, dtype=np.int32)
    blocks = np.asarray(blocks)
    _, block_m, bn = blocks.shape
    if bn != _LANES:
        raise ValueError(f"block width must be {_LANES}, got {bn}")
    mp, np_ = round_up(m, block_m), round_up(n, _LANES)
    nnz = int((blocks != 0).sum())
    n_real = int(bi.size)
    bi, bj, blocks = _canonicalize_blocks(
        bi, bj, lambda order: blocks[order], np_ // _LANES, block_m,
        blocks.dtype)
    return dict(bi=bi.astype(np.int32), bj=bj.astype(np.int32),
                blocks=np.ascontiguousarray(blocks), shape=(m, n),
                padded=(mp, np_), block_m=block_m, nnz=nnz, n_real=n_real)


def _canonicalize_blocks(bi, bj, get_blocks, nb, block_m, dtype):
    """The JAX package's block-list invariants, kept so the packs compare:

    - sorted by (bj, bi);
    - every output group has at least one block: empty groups get an
      explicit zero block (bi = 0);
    - lists of 64 blocks or more are padded with zero blocks at the last
      group (bi = 0, bj = nb - 1) to a multiple of 8, or of 32 from 512.

    K6 needs none of them (its work plan takes any order, and a group with
    no block reduces to zeros); the zero blocks it streams add 0.
    ``get_blocks(order) -> (nblk, block_m, 128)`` fetches the payload in the
    given (bj, bi)-sorted permutation of the input coordinate lists.
    """
    order = np.lexsort((bi, bj))
    blocks = get_blocks(order)
    bi, bj = bi[order], bj[order]
    missing = np.setdiff1d(np.arange(nb), bj)
    if missing.size:
        insert = np.searchsorted(bj, missing)
        bi = np.insert(bi, insert, 0)
        bj = np.insert(bj, insert, missing)
        blocks = np.insert(
            blocks, insert, np.zeros((block_m, _LANES), dtype), axis=0)
    align = 32 if len(bj) >= 512 else 8
    pad = -len(bj) % align if len(bj) >= 64 else 0
    if pad:
        bi = np.concatenate([bi, np.zeros(pad, bi.dtype)])
        bj = np.concatenate([bj, np.full(pad, nb - 1, bj.dtype)])
        blocks = np.concatenate(
            [blocks, np.zeros((pad,) + blocks.shape[1:], dtype)])
    return bi, bj, blocks


class BsrMatrix:
    """BSR-packed A held as tensors on one device."""

    def __init__(self, bi: torch.Tensor, bj: torch.Tensor,
                 blocks: torch.Tensor, shape, padded, block_m: int, nnz: int,
                 n_real: int | None = None):
        self.bi = bi                   # (nblk,) int32 contraction block
        self.bj = bj                   # (nblk,) int32 output group
        self.blocks = blocks           # (nblk, block_m, 128) fp32
        self.shape = tuple(shape)
        self.padded = tuple(padded)
        self.block_m = block_m
        self.nnz = nnz
        # stored blocks before zero padding
        self.n_real = n_real if n_real is not None else int(blocks.shape[0])
        dev = self.device
        # K6's work plans, built once from the host copy of bj
        self._work = None if dev.type != "cuda" else bsr_plans(
            bj.cpu().numpy(), self.padded[1] // _LANES, block_m, dev)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def __repr__(self) -> str:
        return (f"BsrMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"block_m={self.block_m}, blocks={self.n_real}, "
                f"block_density={self.block_density:.2f}, "
                f"device={self.device}, {self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def _from_pack(cls, p: dict[str, Any], device) -> "BsrMatrix":
        dev = resolve_device(device)
        tensors = {k: torch.from_numpy(p[k]).to(dev)
                   for k in ("bi", "bj", "blocks")}
        meta = {k: p[k] for k in ("shape", "padded", "block_m", "nnz",
                                  "n_real")}
        return cls(**tensors, **meta)

    @classmethod
    def from_dense(cls, a, block_m: int = 128, device=None) -> "BsrMatrix":
        """Dense A (numpy or tensor) on ``device`` (None: the GPU)."""
        resolve_device(device)           # fail before packing, not after
        return cls._from_pack(bsr_pack(a, block_m=block_m), device)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, block_m: int = 128,
                 device=None) -> "BsrMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        resolve_device(device)
        return cls._from_pack(bsr_pack_csr(csr, block_m=block_m), device)

    @classmethod
    def from_blocks(cls, m: int, n: int, bi, bj, blocks,
                    device=None) -> "BsrMatrix":
        """scipy-BSR-style ingestion: block (bi[k], bj[k]) = blocks[k]."""
        resolve_device(device)
        return cls._from_pack(bsr_pack_blocks(m, n, bi, bj, blocks), device)

    def device_bytes(self) -> int:
        """Bytes of the blocks and their two int32 coordinate lists."""
        return self.blocks.numel() * self.blocks.element_size() + \
            self.bi.numel() * 8

    def read_bytes(self) -> int:
        """The bytes a product must read of the pack: the real blocks
        (``n_real``, each stored whole, with its two int32 coordinates). The
        zero blocks of canonicalization (a block for each empty output
        group, long lists padded to 8 or 32) need not be read."""
        return self.n_real * (self.block_m * _LANES *
                              self.blocks.element_size() + 8)

    @property
    def block_density(self) -> float:
        """Fraction of (block_m x 128) tiles stored (before padding)."""
        mb = self.padded[0] // self.block_m
        nb = self.padded[1] // _LANES
        return self.n_real / (mb * nb)

    def to_dense(self) -> torch.Tensor:
        """Dense A on the host."""
        bi, bj = self.bi.cpu().numpy(), self.bj.cpu().numpy()
        blocks = self.blocks.cpu().numpy()
        mp, np_ = self.padded
        a = np.zeros((mp, np_), dtype=blocks.dtype)
        for k in range(blocks.shape[0]):
            r0, c0 = bi[k] * self.block_m, bj[k] * _LANES
            a[r0:r0 + self.block_m, c0:c0 + _LANES] += blocks[k]
        return torch.from_numpy(np.ascontiguousarray(
            a[:self.shape[0], :self.shape[1]]))

    def _run(self, x2d: torch.Tensor) -> torch.Tensor:
        mp, np_ = self.padded
        if x2d.ndim != 2 or x2d.shape[1] > mp:
            raise ValueError(f"x must be (b, <={mp}), got {tuple(x2d.shape)}")
        # no padding to the packed rows: the kernel reads them as zero
        return bsr_spmm(self.bi, self.bj, self.blocks, x2d.contiguous(),
                        n_padded=np_, n=self.shape[1], plan=self._work)

    @spanned("tps.spmv")
    def spmv(self, x) -> torch.Tensor:
        """x: (m,) -> y = x @ A, (n,)."""
        return self._run(as_input(x, self.device)[None, :])[0]

    @spanned("tps.spmm")
    def spmm(self, x) -> torch.Tensor:
        """x: (b, m) -> Y = X @ A, (b, n)."""
        return self._run(as_input(x, self.device))
