"""ELL, BELL and K12's plain version in the port against the JAX package.

- Packs are bit-identical: ELL's ``idx``/``val``; BELL's ``bitmap``,
  ``carries``, ``vals``, ``padded``, ``block_m``, ``w`` and ``nnz``, from
  dense and from CSR, at block_m 128, 256 and 512 (and 384, where the
  default 512 clamps to an unaligned M). The JAX packer takes its C++
  bitmap converter; the port's numpy words equal it.
- ``bell_spmm_plain`` stays within 1e-4 of the JAX K12 in Pallas interpret
  mode (``bell_spmm_padded``, whose split-bf16 products sit ~5e-5 off
  fp32) and within 1e-5 of the float64 oracle, at the sizes of
  ``tests/test_sparse_kernels.py`` (512 x 384, d = 0.4, three
  distributions), plus its dense-matrix and empty-matrix cases. The JAX
  calls (~0.5 s each here) are gathered in one module-scoped fixture.
- ELL's gather matches the JAX ``EllMatrix`` and the oracle; both formats
  round-trip through ``to_dense`` and ``from_reference_arrays`` exactly.
"""

import numpy as np
import pytest
import torch

from tpusparse import native
from tpusparse.formats.bell import BellMatrix as JBell
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.formats.ell import EllMatrix as JEll
from tpusparse.kernels.bell_spmv import bell_spmm_padded
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch import from_reference_arrays
from tpusparse_torch.formats import BellMatrix, CsrMatrix, EllMatrix
from tpusparse_torch.formats.bell import (_mask_to_words, _words_to_mask,
                                          bell_pack, bell_pack_csr)
from tpusparse_torch.formats.ell import ell_pack
from tpusparse_torch.kernels.bell_spmv import (bell_spmm, bell_spmm_plain,
                                               expand_mask)

ATOL_JAX = 1e-4
ATOL_ORACLE = 1e-5
DISTS = ("uniform", "powerlaw", "blocks")
BLOCK_MS = (128, 256, 512)


def _matrix(dist):
    return jgen.random_sparse_matrix(512, 384, density=0.4, seed=21,
                                     distribution=dist)


def _special(kind):
    if kind == "dense":       # fully dense: w == block_m
        return np.random.default_rng(0).uniform(-1, 1, (256, 128)) \
            .astype(np.float32)
    return np.zeros((256, 128), np.float32)


def _x(m, batch):
    return jgen.random_sparse_batch(batch, m, 0.5, seed=23)


def _csrs(a):
    jc = JCsr.from_dense(a, use_native=False)
    return CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values), jc


@pytest.fixture(scope="module")
def jax_bell():
    """JAX K12 (Pallas interpret mode) on every case: {key: (B, n)}."""
    out = {}
    cases = [((d, bm), _matrix(d), bm) for d in DISTS for bm in BLOCK_MS]
    cases += [((k, 256), _special(k), 256) for k in ("dense", "empty")]
    for key, a, bm in cases:
        j = JBell.from_dense(a, block_m=bm)
        x = _x(a.shape[0], 4)
        xp = np.pad(x, ((0, 0), (0, j.padded[0] - a.shape[0])))
        y = np.asarray(bell_spmm_padded(j.bitmap, j.carries, j.vals, xp,
                                        block_m=j.block_m, w=j.w))
        out[key] = y[:a.shape[1], :4].T
    return out


def _same(u, v, what):
    u, v = np.asarray(u), np.asarray(v)
    assert u.dtype == v.dtype and u.shape == v.shape, (what, u.dtype,
                                                       v.dtype, u.shape,
                                                       v.shape)
    assert np.array_equal(u, v), what


def same_bell(p, j):
    for k in ("bitmap", "carries", "vals"):
        _same(p[k], getattr(j, k), k)
    for k in ("shape", "padded", "block_m", "w", "nnz"):
        assert tuple(np.atleast_1d(p[k])) == \
            tuple(np.atleast_1d(getattr(j, k))), k


@pytest.mark.parametrize("block_m", BLOCK_MS)
@pytest.mark.parametrize("dist", DISTS)
def test_bell_packs_match_jax(dist, block_m):
    a = _matrix(dist)
    j = JBell.from_dense(a, block_m=block_m)
    p = bell_pack(a, block_m=block_m)
    same_bell(p, j)
    same_bell(bell_pack(torch.from_numpy(a), block_m=block_m), j)
    tc, jc = _csrs(a)
    same_bell(bell_pack_csr(tc, block_m=block_m),
              JBell.from_csr(jc, block_m=block_m))
    # the JAX pack's bitmap came from its C++ converter; so do these words
    padded = np.pad(a, ((0, p["padded"][0] - 512), (0, 0)))
    words = native.bell_bitmap(padded, p["block_m"])
    assert words is not None
    _same(p["bitmap"], words, "native bitmap")
    assert np.array_equal(_words_to_mask(p["bitmap"], p["block_m"]).sum(),
                          p["nnz"])


def test_bell_pack_unaligned_clamps_block_m():
    a = jgen.random_sparse_matrix(300, 200, density=0.3, seed=4)
    j = JBell.from_dense(a)
    p = bell_pack(a)
    assert p["block_m"] == 384
    same_bell(p, j)


def test_mask_words_round_trip():
    rng = np.random.default_rng(3)
    for block_m in (128, 384, 512, 1024):
        mask = rng.random((3, block_m)) < 0.3
        words = _mask_to_words(mask, block_m)
        assert np.array_equal(_words_to_mask(words, block_m), mask)
        t = torch.from_numpy(words.view(np.int32))
        assert torch.equal(expand_mask(t, block_m), torch.from_numpy(mask))


@pytest.mark.parametrize("block_m", BLOCK_MS)
@pytest.mark.parametrize("dist", DISTS)
def test_bell_plain_matches_jax_kernel(jax_bell, dist, block_m):
    a = _matrix(dist)
    f = BellMatrix.from_dense(a, block_m=block_m, device="cpu")
    # the kernel reads the arrays as laid out in memory
    assert all(t.is_contiguous() for t in (f.bitmap, f.carries, f.vals))
    x = _x(512, 4)
    y = bell_spmm_plain(f.bitmap, f.vals, torch.from_numpy(x),
                        block_m=f.block_m, n=384).numpy()
    np.testing.assert_allclose(y, jax_bell[(dist, block_m)], rtol=0,
                               atol=ATOL_JAX)
    np.testing.assert_allclose(y, reference.sgemm_cpu(x, a), rtol=0,
                               atol=ATOL_ORACLE)
    # the public path: spmv and spmm through the wrapper's CPU branch
    np.testing.assert_allclose(f.spmv(x[0]).numpy(),
                               reference.sgemv_cpu(x[0], a), rtol=0,
                               atol=ATOL_ORACLE)
    np.testing.assert_array_equal(
        bell_spmm(f.bitmap, f.vals, torch.from_numpy(x), block_m=f.block_m,
                  n=384).numpy(), y)


@pytest.mark.parametrize("kind", ["dense", "empty"])
def test_bell_dense_and_empty_matrices(jax_bell, kind):
    a = _special(kind)
    f = BellMatrix.from_dense(a, block_m=256, device="cpu")
    x = _x(256, 4)
    y = f.spmm(x).numpy()
    if kind == "dense":
        assert f.w == 256
        np.testing.assert_allclose(y, reference.sgemm_cpu(x, a), rtol=0,
                                   atol=ATOL_ORACLE)
    else:
        assert f.w == 128 and f.nnz == 0
        np.testing.assert_array_equal(y, np.zeros((4, 128), np.float32))
    np.testing.assert_allclose(y, jax_bell[(kind, 256)], rtol=0,
                               atol=ATOL_JAX)
    assert torch.equal(f.to_dense(), torch.from_numpy(a))


@pytest.mark.parametrize("dist", DISTS)
def test_ell_matches_jax(dist):
    a = _matrix(dist)
    j = JEll.from_dense(a)
    p = ell_pack(a)
    _same(p["idx"], j.idx, "idx")
    _same(p["val"], j.val, "val")
    assert p["shape"] == j.shape and p["nnz"] == j.nnz
    f = EllMatrix.from_dense(a, device="cpu")
    x = _x(512, 3)
    np.testing.assert_allclose(f.spmm(x).numpy(), np.asarray(j.spmm(x)),
                               rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(f.spmm(x).numpy(), reference.sgemm_cpu(x, a),
                               rtol=0, atol=ATOL_ORACLE)
    np.testing.assert_allclose(f.spmv(x[0]).numpy(),
                               reference.sgemv_cpu(x[0], a), rtol=0,
                               atol=ATOL_ORACLE)
    assert torch.equal(f.to_dense(), torch.from_numpy(a))
    assert f.device_bytes() == j.device_bytes()


def test_bell_bytes_and_reference_arrays():
    a = _matrix("powerlaw")
    j = JBell.from_dense(a, block_m=256)
    f = BellMatrix.from_dense(a, block_m=256, device="cpu")
    assert f.device_bytes() == j.device_bytes()
    assert f.read_bytes() == f.bitmap.numel() * 4 + 4 * f.nnz
    g = from_reference_arrays(dict(
        kind="bell", bitmap=np.asarray(j.bitmap),
        carries=np.asarray(j.carries), vals=np.asarray(j.vals),
        shape=j.shape, padded=j.padded, block_m=j.block_m, w=j.w,
        nnz=j.nnz), device="cpu")
    assert isinstance(g, BellMatrix)
    for k in ("bitmap", "carries", "vals"):
        assert torch.equal(getattr(g, k), getattr(f, k)), k
    assert torch.equal(g.to_dense(), torch.from_numpy(a))
    je = JEll.from_dense(a)
    e = from_reference_arrays(dict(kind="ell", idx=je.idx, val=je.val,
                                   shape=je.shape, nnz=je.nnz), device="cpu")
    assert isinstance(e, EllMatrix) and torch.equal(e.to_dense(),
                                                    torch.from_numpy(a))
