"""TCSR and K7's plain version in the port against the JAX package.

- Packs are bit-identical (``s_bi``, ``s_bj``, ``idx``, ``vals``, ``w``,
  the dense tier's BSR arrays, ``n_sell``, ``n_dense``, ``nnz``) at
  expect_batch 1 and 8, for an all-SELL, an all-dense, a mixed (the split
  charge set to 0 in both packages, as the JAX test does) and an empty
  matrix; ``_tier_cutoff`` agrees on drawn width demands.
- ``bsell_spmm_plain`` stays within 1e-4 of the JAX package's K7 in Pallas
  interpret mode, and ``TcsrMatrix`` (K7 + K6 on the CPU) within 1e-4 of the
  JAX object and 1e-3 of the float64 oracle. The JAX calls cost about a
  second each and run in a module-scope fixture, at <= 512 x 1024.
- The router sends block-structured matrices to ``TcsrMatrix`` with the
  caller's ``expect_batch``, as the JAX router does.
"""

import numpy as np
import pytest
import torch

import tpusparse.formats.tcsr as jtcsr
import tpusparse_torch
from tpusparse.formats.auto import auto_format as jauto
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.kernels.bsell_spmv import bsell_spmm_padded
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch import from_reference_arrays
from tpusparse_torch.formats import CsrMatrix, TcsrMatrix
from tpusparse_torch.formats import tcsr as ptcsr
from tpusparse_torch.kernels.bsell_spmv import bsell_spmm, bsell_spmm_plain
from tpusparse_torch.testing import generators as tgen

ATOL_JAX = 1e-4
ATOL_ORACLE = 1e-3

# name -> (matrix, expect_batch, split charge zeroed,
#          (n_sell > 0, n_dense > 0) or None)
CASES = {
    "sell_b1": ("bp", 1, False, (True, False)),
    "dense_b8": ("bp", 8, False, (False, True)),
    "low_fill_b8": ("low_fill", 8, False, (False, True)),
    "mixed": ("mixed", 1, True, (True, True)),
    "mixed_b8": ("mixed", 8, True, (False, True)),
    "unaligned": ("unaligned", 1, False, None),
    "empty": ("empty", 1, False, (False, False)),
}


def _matrix(kind):
    if kind == "bp":
        return jgen.block_pruned_matrix(512, 1024, keep_frac=0.3, fill=0.5,
                                        seed=3)
    if kind == "low_fill":
        return jgen.block_pruned_matrix(512, 1024, keep_frac=0.5, fill=0.03,
                                        seed=4)
    if kind == "unaligned":
        return jgen.random_sparse_matrix(300, 200, density=0.3, seed=5,
                                         distribution="blocks", block=64)
    if kind == "empty":
        return np.zeros((256, 384), np.float32)
    # every output group gets two near-full tiles and two sparse ones
    rng = np.random.default_rng(7)
    a = np.zeros((512, 1024), np.float32)
    for g in range(8):
        for k, fill in ((0, 0.97), (1, 0.97), (2, 0.08), (3, 0.08)):
            bi = (g + k) % 4
            tile = rng.uniform(0.1, 1, (128, 128)) * \
                (rng.random((128, 128)) < fill)
            a[bi * 128:(bi + 1) * 128, g * 128:(g + 1) * 128] = tile
    return a


def _csrs(a):
    jc = JCsr.from_dense(a, use_native=False)
    return CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values), jc


def _same(u, v, what):
    u, v = np.asarray(u), np.asarray(v)
    assert u.dtype == v.dtype and u.shape == v.shape, (what, u.dtype, v.dtype,
                                                       u.shape, v.shape)
    assert np.array_equal(u, v), what


def _zero_split(monkeypatch):
    monkeypatch.setattr(jtcsr, "_TIER_SPLIT_BYTES", 0)
    monkeypatch.setattr(ptcsr, "_TIER_SPLIT_BYTES", 0)


@pytest.mark.parametrize("name", list(CASES))
def test_packs_match_jax(name, monkeypatch):
    kind, batch, zero_split, tiers = CASES[name]
    if zero_split:
        _zero_split(monkeypatch)
    tc, jc = _csrs(_matrix(kind))
    p = ptcsr.tcsr_pack_csr(tc, expect_batch=batch)
    q = jtcsr.tcsr_pack_csr(jc, expect_batch=batch)
    for k in ("s_bi", "s_bj", "idx", "vals"):
        _same(p[k], q[k], k)
    for k in ("w", "shape", "padded", "nnz", "n_sell", "n_dense"):
        assert tuple(np.atleast_1d(p[k])) == tuple(np.atleast_1d(q[k])), k
    assert (p["bsr"] is None) == (q["bsr"] is None)
    if q["bsr"] is not None:
        for k in ("bi", "bj", "blocks"):
            _same(p["bsr"][k], getattr(q["bsr"], k), "bsr." + k)
        for k in ("shape", "padded", "block_m", "nnz", "n_real"):
            assert tuple(np.atleast_1d(p["bsr"][k])) == \
                tuple(np.atleast_1d(getattr(q["bsr"], k))), k
    if tiers is not None:
        assert (p["n_sell"] > 0, p["n_dense"] > 0) == tiers


def test_tier_cutoff_matches_jax_on_drawn_demands():
    rng = np.random.default_rng(0)
    for _ in range(200):
        k = int(rng.integers(0, 80))
        nb = int(rng.integers(1, 9))
        w_b = rng.integers(1, 129, size=k)
        tile_bj = rng.integers(0, nb, size=k)
        for batch in (1, 2, 8):
            assert ptcsr._tier_cutoff(w_b, batch, tile_bj, nb) == \
                jtcsr._tier_cutoff(w_b, batch, tile_bj, nb)
        assert ptcsr._tier_cutoff(w_b, 1) == jtcsr._tier_cutoff(w_b, 1)


@pytest.fixture(scope="module")
def jax_products():
    """The JAX package's K7 (interpret mode) on the SELL tier of two
    packs, and its TcsrMatrix products (K7 and K6) on three."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for kind, batch, zero_split in [("bp", 1, False), ("bp", 3, False),
                                        ("mixed", 2, True)]:
            if zero_split:
                mp.setattr(jtcsr, "_TIER_SPLIT_BYTES", 0)
            a = _matrix(kind)
            j = jtcsr.TcsrMatrix.from_dense(a, expect_batch=1)
            x = jgen.random_sparse_batch(batch, a.shape[0], 0.5, seed=21)
            jk = None
            if kind == "bp":
                jk = np.asarray(bsell_spmm_padded(
                    j.s_bi, j.s_bj, j.idx, j.vals, x, w=j.w,
                    n_padded=j.padded[1]))[::8][:batch]
            out[kind, batch] = (a, x, jk, np.asarray(j.spmm(x)))
            mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind,batch", [("bp", 1), ("bp", 3), ("mixed", 2)])
def test_plain_and_matrix_match_jax_interpret(jax_products, monkeypatch,
                                              kind, batch):
    a, x, jk, jy = jax_products[kind, batch]
    if kind == "mixed":
        _zero_split(monkeypatch)
    t = TcsrMatrix.from_dense(a, device="cpu")
    assert (t.n_sell > 0, t.n_dense > 0) == ((True, kind == "mixed"))
    xt = torch.from_numpy(x)
    y_ref = reference.sgemm_cpu(x, a)
    if jk is not None:
        args = (t.s_bi, t.s_bj, t.idx, t.vals, xt)
        y = bsell_spmm_plain(*args, n_padded=t.padded[1])
        assert torch.equal(bsell_spmm(*args, n_padded=t.padded[1]), y)
        np.testing.assert_allclose(y.numpy(), jk, rtol=0, atol=ATOL_JAX)
    ty = t.spmm(x)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(ty.numpy(), y_ref, rtol=0, atol=ATOL_ORACLE)
    np.testing.assert_allclose(t.spmv(x[0]).numpy(),
                               reference.sgemv_cpu(x[0], a), rtol=0,
                               atol=ATOL_ORACLE)


@pytest.mark.parametrize("name", ["sell_b1", "dense_b8", "mixed",
                                  "unaligned", "empty"])
def test_round_trips_and_products(name, monkeypatch):
    kind, batch, zero_split, _ = CASES[name]
    if zero_split:
        _zero_split(monkeypatch)
    a = _matrix(kind)
    t = TcsrMatrix.from_dense(a, expect_batch=batch, device="cpu")
    j = jtcsr.TcsrMatrix.from_dense(a, expect_batch=batch)
    assert np.array_equal(t.to_dense().numpy(), a)
    assert t.device_bytes() == j.device_bytes()
    b = j.bsr
    d = dict(kind="tcsr", s_bi=np.asarray(j.s_bi), s_bj=np.asarray(j.s_bj),
             idx=np.asarray(j.idx), vals=np.asarray(j.vals), w=j.w,
             bsr=None if b is None else dict(
                 bi=np.asarray(b.bi), bj=np.asarray(b.bj),
                 blocks=np.asarray(b.blocks), shape=b.shape,
                 padded=b.padded, block_m=b.block_m, nnz=b.nnz,
                 n_real=b.n_real),
             shape=j.shape, padded=j.padded, nnz=j.nnz, n_sell=j.n_sell,
             n_dense=j.n_dense)
    r = from_reference_arrays(d, device="cpu")
    assert isinstance(r, TcsrMatrix) and repr(r) == repr(t)
    x = jgen.random_sparse_batch(3, a.shape[0], 0.5, seed=22)
    y = r.spmm(x)
    assert torch.equal(y, t.spmm(x)) and y.shape == (3, a.shape[1])
    np.testing.assert_allclose(y.numpy(), reference.sgemm_cpu(x, a), rtol=0,
                               atol=ATOL_ORACLE)
    if kind == "empty":
        assert torch.count_nonzero(y) == 0


@pytest.mark.parametrize("batch", [1, 8])
def test_router_sends_block_structure_to_tcsr(batch):
    """The block-structured cases of the JAX router tests: the same class,
    the same tiers."""
    for a in (jgen.random_sparse_matrix(512, 384, density=0.3, seed=2,
                                        distribution="blocks"),
              tgen.block_pruned_matrix(1024, 1024, keep_frac=0.3, fill=0.5,
                                       seed=5)):
        j = jauto(a, expect_batch=batch)
        t = tpusparse_torch.auto_format(a, expect_batch=batch, device="cpu")
        assert type(t).__name__ == type(j).__name__ == "TcsrMatrix"
        assert (t.n_sell, t.n_dense, t.w) == (j.n_sell, j.n_dense, j.w)
        tc, _ = _csrs(a)
        tt = tpusparse_torch.auto_format(tc, expect_batch=batch,
                                         device="cpu")
        assert (tt.n_sell, tt.n_dense, tt.w) == (t.n_sell, t.n_dense, t.w)
        x = jgen.random_sparse_vector(a.shape[0], 0.5, seed=3)
        np.testing.assert_allclose(tpusparse_torch.spmv(t, x).numpy(),
                                   reference.sgemv_cpu(x, a), rtol=0,
                                   atol=ATOL_ORACLE)
