"""Binned SELL in the port against the JAX package.

- ``_pick_levels`` gives the JAX levels on drawn width demands.
- Packs are identical: ``widths``, ``inv_perm``, every bucket's
  ``idx``/``vals`` and the permute plan, from dense and from CSR, on
  uniform, power-law, block and unaligned matrices.
- ``spmv``/``spmm`` (K1 per bucket, then K5, here through their plain
  versions) stay within 1e-4 of the JAX package (K1 in Pallas interpret
  mode, split-bf16 products) and 1e-5 of the float64 oracle. The JAX
  products cost ~3 s each here, so only two run, in a module-scoped
  fixture.
"""

import numpy as np
import pytest
import torch

from tpusparse.formats.binned import BinnedSellMatrix as JBinned
from tpusparse.formats.binned import _pick_levels as jpick
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch import from_reference_arrays
from tpusparse_torch.formats import BinnedSellMatrix, CsrMatrix
from tpusparse_torch.formats.binned import (_pick_levels, binned_pack,
                                            binned_pack_csr)

CASES = {
    "uniform": (512, 384, 0.4, "uniform", 21),
    "powerlaw": (1024, 512, 0.15, "powerlaw", 4),
    "blocks": (512, 384, 0.3, "blocks", 2),
    "unaligned": (300, 200, 0.3, "powerlaw", 6),
}


def _matrix(name):
    m, n, d, dist, seed = CASES[name]
    return jgen.random_sparse_matrix(m, n, density=d, seed=seed,
                                     distribution=dist)


def _csrs(a):
    jc = JCsr.from_dense(a, use_native=False)
    return CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values), jc


def same_binned(p, j):
    assert p["widths"] == j.widths and p["shape"] == tuple(j.shape)
    assert p["nnz"] == j.nnz
    assert np.array_equal(p["inv_perm"], np.asarray(j.inv_perm))
    assert p["inv_perm"].dtype == np.asarray(j.inv_perm).dtype
    assert len(p["buckets"]) == len(j.buckets)
    for pb, jb in zip(p["buckets"], j.buckets):
        for k in ("idx", "vals"):
            u, v = pb[k], np.asarray(jb[k])
            assert u.dtype == v.dtype and np.array_equal(u, v), k
    for u, v in zip(p["perm_plan"], j.perm_plan):
        assert np.array_equal(u, np.asarray(v))


@pytest.fixture(scope="module")
def jax_products():
    """JAX spmv on 'powerlaw' and spmm (B = 4) on 'uniform'."""
    out = {}
    x = jgen.random_sparse_vector(1024, 0.5, seed=8)
    out["powerlaw"] = (x, np.asarray(JBinned.from_dense(
        _matrix("powerlaw")).spmv(x)))
    xb = jgen.random_sparse_batch(4, 512, 0.5, seed=9)
    out["uniform"] = (xb, np.asarray(JBinned.from_dense(
        _matrix("uniform")).spmm(xb)))
    return out


def test_pick_levels_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        gw = rng.integers(0, rng.choice([9, 40, 200]), rng.integers(1, 40))
        for k in (1, 2, 3):
            assert _pick_levels(gw, k) == jpick(gw, k), (gw, k)


@pytest.mark.parametrize("name", list(CASES))
def test_packs_match_jax(name):
    a = _matrix(name)
    j = JBinned.from_dense(a)
    same_binned(binned_pack(a), j)
    same_binned(binned_pack(torch.from_numpy(a)), j)
    tc, jc = _csrs(a)
    same_binned(binned_pack_csr(tc), JBinned.from_csr(jc))
    f = BinnedSellMatrix.from_dense(a, device="cpu")
    assert torch.equal(f.to_dense(), torch.from_numpy(a))
    assert f.device_bytes() == j.device_bytes()
    assert torch.equal(f.perm_src.long(), torch.from_numpy(
        np.asarray(j.inv_perm)).long())


@pytest.mark.parametrize("name", ["powerlaw", "uniform"])
def test_products_match_jax(jax_products, name):
    a = _matrix(name)
    x, jy = jax_products[name]
    f = BinnedSellMatrix.from_dense(a, device="cpu")
    y = (f.spmv(x) if x.ndim == 1 else f.spmm(x)).numpy()
    want = reference.sgemv_cpu(x, a) if x.ndim == 1 \
        else reference.sgemm_cpu(x, a)
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5)


def test_unaligned_products_and_reference_arrays():
    a = _matrix("unaligned")
    j = JBinned.from_dense(a)
    f = from_reference_arrays(dict(
        kind="binned", idx=[np.asarray(b["idx"]) for b in j.buckets],
        vals=[np.asarray(b["vals"]) for b in j.buckets],
        inv_perm=np.asarray(j.inv_perm), shape=j.shape, nnz=j.nnz,
        widths=j.widths), device="cpu")
    assert isinstance(f, BinnedSellMatrix) and f.widths == j.widths
    assert torch.equal(f.to_dense(), torch.from_numpy(a))
    xb = jgen.random_sparse_batch(3, 300, 0.5, seed=6)
    y = f.spmm(xb)
    assert y.shape == (3, 200)
    np.testing.assert_allclose(y.numpy(), reference.sgemm_cpu(xb, a),
                               rtol=0, atol=1e-5)
