"""DIA and K8's plain version in the port against the JAX package.

- Packs are bit-identical (``offsets``, ``vals``, ``shape``, ``nnz``,
  ``sym``): full and symmetric storage, the ``symmetric=True`` guard, the
  ``max_diags`` guard, and duplicate positions summing. ``halo_rows`` and
  ``fits`` agree, so both packages pick the kernel for the same operators.
- ``dia_spmv_plain`` stays within 1e-4 of the JAX package's K8 in Pallas
  interpret mode (n >= 1024, so that ``fits`` holds), with and without
  ``sym`` and at an n that is no multiple of 128; ``DiaMatrix`` spmv/spmm on
  the CPU stay within 1e-4 of the JAX object (its kernel or its XLA form,
  whichever it runs) and 1e-3 of the float64 oracle.
- The router sends the banded cases of the JAX DIA tests to ``DiaMatrix``.
"""

import numpy as np
import pytest
import torch

import tpusparse_torch
from tpusparse.formats.auto import auto_format as jauto
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.formats.dia import DiaMatrix as JDia
from tpusparse.formats.dia import dia_pack_csr as jpack
from tpusparse.kernels.dia_spmv import dia_spmv_pallas
from tpusparse.kernels.dia_spmv import fits as jfits
from tpusparse.kernels.dia_spmv import halo_rows as jhalo
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch import from_reference_arrays
from tpusparse_torch.formats import CsrMatrix, DiaMatrix
from tpusparse_torch.formats.dia import dia_pack_csr
from tpusparse_torch.kernels.dia_spmv import (dia_spmv, dia_spmv_plain, fits,
                                              halo_rows)
from tpusparse_torch.testing import generators as tgen

ATOL_JAX = 1e-4
ATOL_ORACLE = 1e-3


def _banded():
    """The JAX DIA tests' fixture: non-square, a band crossing both edges,
    plus far off-diagonals."""
    a = jgen.random_sparse_matrix(384, 320, density=0.9, seed=101)
    ii, jj = np.indices(a.shape)
    mask = np.isin(ii - jj, (-130, -2, -1, 0, 1, 3, 257))
    return np.where(mask, a, 0).astype(np.float32)


def _square_banded(n=1100, offsets=(-300, -5, 0, 2, 129), seed=7):
    """A square, asymmetric banded operator at an n that is no multiple of
    128."""
    rng = np.random.default_rng(seed)
    ii, jj = np.indices((n, n))
    a = rng.uniform(-1, 1, (n, n)) * np.isin(ii - jj, offsets)
    return a.astype(np.float32)


def _sym_widened():
    """test_dia.py's symmetric operator whose fill only passes the halved
    (symmetric) DIA admission."""
    rng = np.random.default_rng(120)
    n = 512
    a = np.zeros((n, n), dtype=np.float32)
    ii, jj = np.indices(a.shape)
    d = ii - jj
    for off in (0, 1, 5, 33):
        band = (d == off) & (rng.random((n, n)) < (1.0 if off == 0
                                                   else 0.25))
        a[band] = rng.normal(size=int(band.sum())).astype(np.float32)
    return (a + np.tril(a, -1).T).astype(np.float32)


def _csr(kind):
    if kind == "stencil2d":
        return jgen.stencil_csr((32, 32))
    if kind == "stencil3d_27":
        return jgen.stencil_csr((8, 8, 16), points=27)
    if kind == "aniso":
        return jgen.stencil_csr((40, 30), eps=100.0)
    a = {"banded": _banded, "square": _square_banded,
         "sym_widened": _sym_widened}[kind]()
    return JCsr.from_dense(a, use_native=False)


def _port(jc):
    return CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values)


def _same_pack(p, q):
    assert p["offsets"] == q["offsets"] and p["sym"] == q["sym"]
    assert p["shape"] == q["shape"] and p["nnz"] == q["nnz"]
    assert p["vals"].dtype == q["vals"].dtype
    assert np.array_equal(p["vals"], q["vals"])


@pytest.mark.parametrize("symmetric", ["auto", False, True])
@pytest.mark.parametrize("kind", ["stencil2d", "stencil3d_27", "aniso",
                                  "banded", "square", "sym_widened"])
def test_packs_match_jax(kind, symmetric):
    jc = _csr(kind)
    if symmetric is True and kind in ("banded", "square"):
        for f in (dia_pack_csr, jpack):
            with pytest.raises(ValueError, match="symmetric=True"):
                f(_port(jc) if f is dia_pack_csr else jc, symmetric=True)
        return
    p = dia_pack_csr(_port(jc), symmetric=symmetric)
    _same_pack(p, jpack(jc, symmetric=symmetric))
    assert p["sym"] == (symmetric is not False
                        and kind not in ("banded", "square"))


def test_guards_and_duplicates_match_jax():
    a = jgen.random_sparse_matrix(256, 256, density=0.5, seed=105)
    jc = JCsr.from_dense(a, use_native=False)
    for f, c in ((dia_pack_csr, _port(jc)), (jpack, jc)):
        with pytest.raises(ValueError, match="diagonals"):
            f(c, max_diags=16)
    rows = np.array([0, 0, 5, 9])
    cols = np.array([0, 0, 5, 3])
    vals = np.array([1.0, 2.0, 4.0, -1.0], np.float32)
    c = CsrMatrix.from_coo(12, 10, rows, cols, vals)
    _same_pack(dia_pack_csr(c), jpack(JCsr.from_coo(12, 10, rows, cols,
                                                    vals)))
    d = DiaMatrix.from_csr(c, device="cpu").to_dense()
    assert d[0, 0] == 3.0 and d[5, 5] == 4.0 and d[9, 3] == -1.0
    empty = CsrMatrix.from_coo(1024, 1024, [], [], np.zeros(0, np.float32))
    t = DiaMatrix.from_csr(empty, device="cpu")
    assert t.sym and t.offsets == () and t.vals.shape == (1, 1024)
    assert torch.count_nonzero(t.spmv(np.ones(1024, np.float32))) == 0


def test_halo_rows_and_fits_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(300):
        k = int(rng.integers(0, 40))
        offs = tuple(sorted(set(int(v) for v in
                                rng.integers(-70000, 70000, size=k))))
        n = int(rng.choice([100, 1023, 1024, 5000, 1 << 20]))
        for sym in (False, True):
            assert halo_rows(offs, sym) == jhalo(offs, sym)
            assert fits(offs, sym, n) == jfits(offs, sym, n)


@pytest.fixture(scope="module")
def jax_products():
    """The JAX package's K8 in interpret mode, and its DiaMatrix spmv/spmm
    (kernel or XLA form, as it chooses), on four operators."""
    out = {}
    for kind in ("stencil2d", "stencil3d_27", "square", "banded"):
        jc = _csr(kind)
        j = JDia.from_csr(jc)
        m, n = jc.shape
        x = jgen.random_sparse_vector(m, 0.5, seed=31)
        xb = jgen.random_sparse_batch(3, m, 0.5, seed=32)
        jk = None
        if m == n:
            jk = np.asarray(dia_spmv_pallas(j.offsets, j.vals, x, sym=j.sym,
                                            n=n))
        out[kind] = (jc, x, xb, jk, np.asarray(j.spmv(x)),
                     np.asarray(j.spmm(xb)))
    return out


@pytest.mark.parametrize("kind", ["stencil2d", "stencil3d_27", "square",
                                  "banded"])
def test_plain_and_matrix_match_jax_interpret(jax_products, kind):
    jc, x, xb, jk, jy, jyb = jax_products[kind]
    a = jc.to_dense()
    t = DiaMatrix.from_csr(_port(jc), device="cpu")
    m, n = t.shape
    assert fits(t.offsets, t.sym, n) == (m == n)
    if jk is not None:
        xt = torch.from_numpy(x)
        y = dia_spmv_plain(t.offsets, t.vals, xt, sym=t.sym, n=n)
        assert torch.equal(dia_spmv(t.offsets, t.vals, xt, sym=t.sym, n=n),
                           y)
        np.testing.assert_allclose(y.numpy(), jk, rtol=0, atol=ATOL_JAX)
        assert torch.equal(t.spmv(x), y)              # spmv runs K8
    ty, tyb = t.spmv(x), t.spmm(xb)
    assert ty.shape == jy.shape and tyb.shape == jyb.shape
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(tyb.numpy(), jyb, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(ty.numpy(), reference.sgemv_cpu(x, a), rtol=0,
                               atol=ATOL_ORACLE)
    np.testing.assert_allclose(tyb.numpy(), reference.sgemm_cpu(xb, a),
                               rtol=0, atol=ATOL_ORACLE)
    assert t.spmv(xb).shape == (3, n)                 # 2-D x goes to spmm


@pytest.mark.parametrize("kind", ["stencil2d", "square", "banded",
                                  "sym_widened"])
def test_shifted_form_desym_and_round_trip(kind):
    jc = _csr(kind)
    a = jc.to_dense()
    t = DiaMatrix.from_csr(_port(jc), device="cpu")
    j = JDia.from_csr(jc)
    assert np.array_equal(t.to_dense().numpy(), a)
    assert t.device_bytes() == j.device_bytes()
    full, jfull = t.desym(), j.desym()
    assert full.offsets == jfull.offsets and not full.sym
    assert np.array_equal(full.vals.numpy(), np.asarray(jfull.vals))
    assert np.array_equal(full.to_dense().numpy(), a)
    r = from_reference_arrays(dict(kind="dia", offsets=j.offsets,
                                   vals=np.asarray(j.vals), shape=j.shape,
                                   nnz=j.nnz, sym=j.sym), device="cpu")
    assert isinstance(r, DiaMatrix) and repr(r) == repr(t)
    x = jgen.random_sparse_vector(a.shape[0], 0.5, seed=33)
    shifted = DiaMatrix(t.offsets, t.vals, t.shape, t.nnz, sym=t.sym,
                        xla_only=True)
    for f in (r, full, shifted):
        np.testing.assert_allclose(f.spmv(x).numpy(), t.spmv(x).numpy(),
                                   rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(shifted.spmv(x).numpy(),
                               reference.sgemv_cpu(x, a), rtol=0,
                               atol=ATOL_ORACLE)


@pytest.mark.parametrize("kind", ["banded", "sym_widened", "stencil2d",
                                  "aniso"])
def test_router_sends_banded_to_dia(kind):
    """test_dia.py's banded routing cases (and two lattice operators of
    the JAX gallery): the same class, the same storage."""
    jc = _csr(kind)
    a = jc.to_dense()
    j = jauto(a)
    t = tpusparse_torch.auto_format(a, device="cpu")
    assert type(t).__name__ == type(j).__name__ == "DiaMatrix"
    assert t.offsets == j.offsets and t.sym == j.sym
    tc = tpusparse_torch.auto_format(_port(jc), device="cpu")
    assert isinstance(tc, DiaMatrix) and tc.offsets == t.offsets
    x = jgen.random_sparse_vector(a.shape[0], 0.5, seed=34)
    np.testing.assert_allclose(tpusparse_torch.spmv(t, x).numpy(),
                               reference.sgemv_cpu(x, a), rtol=0,
                               atol=ATOL_ORACLE)


def test_generators_match_jax():
    for dims, points, eps in [((32, 32), None, 1.0), ((8, 8, 16), 27, 1.0),
                              ((9, 7), 9, 1.0), ((5, 6, 7), None, 0.01),
                              ((40, 30), None, 100.0)]:
        c = jgen.stencil_csr(dims, points=points, eps=eps)
        t = tgen.stencil_csr(dims, points=points, eps=eps)
        assert t.shape == c.shape
        for k in ("row_ptr", "col_idx", "values"):
            u, v = getattr(t, k), getattr(c, k)
            assert u.dtype == v.dtype and np.array_equal(u, v), k
    with pytest.raises(ValueError, match="unsupported stencil"):
        tgen.stencil_csr((4, 4), points=7)
    for args in [(512, 1024, 128, 0.3, 0.5, 9), (300, 200, 64, 0.1, 0.9, 2),
                 (64, 64, 128, 0.0, 0.5, 1)]:
        u = tgen.block_pruned_matrix(*args[:2], block=args[2],
                                     keep_frac=args[3], fill=args[4],
                                     seed=args[5])
        v = jgen.block_pruned_matrix(*args[:2], block=args[2],
                                     keep_frac=args[3], fill=args[4],
                                     seed=args[5])
        assert u.dtype == v.dtype and np.array_equal(u, v)
