"""K11's plain version (SELL decompress-to-dense SpMM) against the JAX
package's K11 in Pallas interpret mode, on the case of
``tests/test_sparse_kernels.py``: 384 x 256, d = 0.2, with row 0 set to 1
so every column holds an offset-0 entry that the pad slots (index 0, value
0) alias. B in {1, 3, 8}: within 1e-4 of the JAX kernel (split-bf16
products, ~3e-5 off fp32) and 1e-5 of the float64 oracle. The JAX calls
(~1 s each here) run once, in a module-scoped fixture.

The CUDA kernel builds its dense tiles by stores, not adds; a numpy model
of its scatter (store each nonzero slot, and where a column names one
offset twice, add the warp's 16 columns in slot order instead) gives the
plain version's additive tiles bit for bit, on a dense pack, on the
pad-collision matrix and on a CSR with repeated entries.
"""

import numpy as np
import pytest
import torch

from tpusparse.formats.sell import SellMatrix as JSell
from tpusparse.kernels.sell_mxu_spmm import sell_mxu_spmm_padded
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch.formats import CsrMatrix, SellMatrix
from tpusparse_torch.kernels.sell_mxu_spmm import (sell_mxu_spmm,
                                                   sell_mxu_spmm_plain)

BATCHES = (1, 3, 8)


def _matrix():
    a = jgen.random_sparse_matrix(384, 256, density=0.2, seed=61)
    a[0, :] = 1.0          # c = 0 entries in every column: pad collision bait
    return a


def _x(b):
    return jgen.random_sparse_batch(b, 384, density=0.5, seed=61)


@pytest.fixture(scope="module")
def jax_mxu():
    s = JSell.from_dense(_matrix())
    return {b: np.asarray(sell_mxu_spmm_padded(s.idx, s.vals, _x(b),
                                               w=s.w))[:b, :256]
            for b in BATCHES}


@pytest.mark.parametrize("batch", BATCHES)
def test_plain_matches_jax_kernel(jax_mxu, batch):
    a = _matrix()
    f = SellMatrix.from_dense(a, device="cpu")
    x = torch.from_numpy(_x(batch))
    y = sell_mxu_spmm_plain(f.idx, f.vals, x, n=256).numpy()
    np.testing.assert_allclose(y, jax_mxu[batch], rtol=0, atol=1e-4)
    np.testing.assert_allclose(y, reference.sgemm_cpu(x.numpy(), a), rtol=0,
                               atol=1e-5)
    # the wrapper's CPU branch is the plain version
    np.testing.assert_array_equal(
        sell_mxu_spmm(f.idx, f.vals, x, n=256).numpy(), y)


def test_scatter_must_add():
    """Pad slots alias offset 0: an overwriting scatter loses the real
    offset-0 entries, the additive one keeps them."""
    a = _matrix()
    f = SellMatrix.from_dense(a, device="cpu")
    assert bool((f.idx[:, 0, 1:] == 0).any())      # pads exist in window 0
    x = torch.from_numpy(_x(3))
    nb, nt, w, _ = f.vals.shape
    lane = torch.arange(128)
    flat = (f.idx.long() * 128 + lane).reshape(nb, nt, w * 128)
    stored = torch.zeros((nb, nt, 128 * 128)).scatter_(
        2, flat, f.vals.reshape(nb, nt, w * 128))
    y_store = torch.einsum("btc,jtcr->bjr", x.reshape(3, nt, 128),
                           stored.view(nb, nt, 128, 128)).reshape(3, -1)
    want = reference.sgemm_cpu(x.numpy(), a)
    assert np.abs(y_store.numpy() - want).max() > 1e-2
    y = sell_mxu_spmm_plain(f.idx, f.vals, x, n=256).numpy()
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5)


def test_unaligned_shapes_and_short_x():
    """m and n off the 128 grid; x as narrow as m (the missing packed rows
    read as zero)."""
    a = jgen.random_sparse_matrix(200, 300, density=0.3, seed=5)
    f = SellMatrix.from_dense(a, device="cpu")
    x = jgen.random_sparse_batch(5, 200, 0.5, seed=5)
    y = sell_mxu_spmm_plain(f.idx, f.vals, torch.from_numpy(x), n=300)
    assert y.shape == (5, 300)
    np.testing.assert_allclose(y.numpy(), reference.sgemm_cpu(x, a), rtol=0,
                               atol=1e-5)


def _plain_tiles(idx, vals):
    """The dense tiles exactly as sell_mxu_spmm_plain builds them: an
    additive scatter in slot order, pads included. (nb, nt, c, r) fp32."""
    nb, nt, w, _ = vals.shape
    lane = torch.arange(128)
    out = torch.empty((nb, nt, 128, 128), dtype=torch.float32)
    for j in range(nb):
        flat = (idx[j].long() * 128 + lane).reshape(nt, w * 128)
        dense = torch.zeros((nt, 128 * 128), dtype=torch.float32)
        dense.scatter_add_(1, flat, vals[j].float().reshape(nt, w * 128))
        out[j] = dense.view(nt, 128, 128)
    return out.numpy()


def _store_tiles(idx, vals, fall_back=True):
    """A numpy model of the CUDA kernel's scatter: on a zeroed tile, store
    each slot's value at (idx, r) unless it is 0; where a column holds one
    offset twice (``fall_back``), the kernel's warp (16 columns) clears its
    rows and adds its slots in slot order instead."""
    idx, vals = idx.numpy().astype(np.int64), vals.numpy()
    nb, nt, w, _ = vals.shape
    tiles = np.zeros((nb, nt, 128, 128), np.float32)
    j, t, s, r = np.nonzero(vals != 0)           # slot order within a cell
    c = idx[j, t, s, r]
    tiles[j, t, c, r] = vals[j, t, s, r]
    if fall_back:
        cell = ((j * nt + t) * 128 + c) * 128 + r
        _, first, counts = np.unique(cell, return_index=True,
                                     return_counts=True)
        warps = {(j[k], t[k], r[k] // 16) for k in first[counts > 1]}
        for jj, tt, ww in warps:
            cols = slice(16 * ww, 16 * ww + 16)
            tiles[jj, tt, :, cols] = 0.0
            pick = (j == jj) & (t == tt) & (r // 16 == ww)
            np.add.at(tiles[jj, tt], (c[pick], r[pick]),
                      vals[jj, tt, s[pick], r[pick]])
    return tiles


def _dup_csr():
    """A CsrMatrix with repeated entries (pairs and triples, some of equal
    value): from_coo keeps them, and the SELL packer gives each its slot."""
    rng = np.random.default_rng(5)
    m, n, nnz = 300, 260, 6000
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    rows[:400], cols[:400] = rows[400:800], cols[400:800]
    rows[:50], cols[:50] = rows[800:850], cols[800:850]
    vals = rng.uniform(-1, 1, nnz).astype(np.float32)
    vals[:30] = vals[800:830]
    return CsrMatrix.from_coo(m, n, rows, cols, vals)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("case", ["from_dense", "pad_collision",
                                  "from_csr_duplicates"])
def test_store_scatter_equals_additive_tiles(case):
    """The kernel's store scatter gives the plain version's additive tiles
    bit for bit, on a dense pack, on the pad-collision matrix (row 0 all
    ones: every column's offset-0 entry shares its offset with the pads),
    and on a CSR with duplicate entries (through the fallback)."""
    if case == "from_dense":
        f = SellMatrix.from_dense(
            jgen.random_sparse_matrix(300, 400, density=0.3, seed=8),
            device="cpu")
    elif case == "pad_collision":
        f = SellMatrix.from_dense(_matrix(), device="cpu")
    else:
        f = SellMatrix.from_csr(_dup_csr(), device="cpu")
    want = _plain_tiles(f.idx, f.vals)
    np.testing.assert_array_equal(_bits(_store_tiles(f.idx, f.vals)),
                                  _bits(want))
    if case == "from_csr_duplicates":
        # without the fallback the stores would lose repeated entries
        plain_store = _store_tiles(f.idx, f.vals, fall_back=False)
        assert not np.array_equal(_bits(plain_store), _bits(want))
