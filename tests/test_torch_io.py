"""Pack persistence across the two packages: every kind of the JAX
``formats/io.py`` registry (a sorted and an unsorted RSELL, fp32 and bf16
SELL), saved by the JAX package and loaded by the port, and saved by the
port and loaded by the JAX package. The files' arrays must be
bit-identical and the port's products within 1e-4 of the float64 oracle."""

import ml_dtypes
import numpy as np
import pytest
import torch

import tpusparse.formats as jfmt
from tpusparse.formats import io as jio
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.kernels.asp_spmv import AspMatrix as JAsp
from tpusparse.testing import generators as jgen

import tpusparse_torch.formats as tfmt
from tpusparse_torch.formats import io as tio
from tpusparse_torch.formats.convert import from_reference_arrays
from tpusparse_torch.formats.csr import CsrMatrix as TCsr
from tpusparse_torch.kernels.asp_spmv import AspMatrix as TAsp
from tpusparse_torch.testing import generators as tgen

CPU = "cpu"


def _mixed_tiles():
    """Half the 128-tiles dense-ish, half sparse, some empty: both TCSR
    tiers."""
    a = jgen.random_sparse_matrix(512, 384, density=0.04, seed=5)
    dense = jgen.random_sparse_matrix(512, 384, density=0.9, seed=6)
    a[:128, :128] = dense[:128, :128]
    a[256:384, 256:384] = dense[256:384, 256:384]
    a[384:, 128:256] = 0.0
    return a


def _matrices():
    uni = jgen.random_sparse_matrix(384, 256, density=0.3, seed=1)
    skew = jgen.random_sparse_matrix(512, 384, density=0.15, seed=2,
                                     distribution="powerlaw")
    band = jgen.random_sparse_matrix(300, 300, density=0.6, seed=3,
                                     distribution="banded")
    band = np.tril(np.triu(band, -3), 3)
    band = band + band.T
    return dict(uni=uni, skew=skew, band=band, mixed=_mixed_tiles())


M = _matrices()

# name -> (matrix, JAX pack of it, port pack of it)
CASES = {
    "sell": ("uni", lambda a: jfmt.SellMatrix.from_dense(a),
             lambda a: tfmt.SellMatrix.from_dense(a, device=CPU)),
    "sell_bf16": ("uni",
                  lambda a: jfmt.SellMatrix.from_dense(
                      a, dtype=ml_dtypes.bfloat16),
                  lambda a: tfmt.SellMatrix.from_dense(
                      a, dtype=torch.bfloat16, device=CPU)),
    "sell_int8": ("uni", lambda a: jfmt.SellMatrix.from_dense(a, dtype="int8"),
                  lambda a: tfmt.SellMatrix.from_dense(a, dtype="int8",
                                                       device=CPU)),
    "awsp": ("uni", lambda a: jfmt.AwspMatrix.from_dense(a, g=2),
             lambda a: tfmt.AwspMatrix.from_dense(a, g=2, device=CPU)),
    "bsr": ("mixed", lambda a: jfmt.BsrMatrix.from_dense(a),
            lambda a: tfmt.BsrMatrix.from_dense(a, device=CPU)),
    "tcsr": ("mixed", lambda a: jfmt.TcsrMatrix.from_dense(a),
             lambda a: tfmt.TcsrMatrix.from_dense(a, device=CPU)),
    "tcsr_sell_only": ("uni", lambda a: jfmt.TcsrMatrix.from_dense(a),
                       lambda a: tfmt.TcsrMatrix.from_dense(a, device=CPU)),
    "dia": ("band", lambda a: jfmt.DiaMatrix.from_dense(a),
            lambda a: tfmt.DiaMatrix.from_dense(a, device=CPU)),
    "rsell_sorted": ("skew", lambda a: jfmt.RsellMatrix.from_dense(a),
                     lambda a: tfmt.RsellMatrix.from_dense(a, device=CPU)),
    "rsell_unsorted": ("uni", lambda a: jfmt.RsellMatrix.from_dense(a),
                       lambda a: tfmt.RsellMatrix.from_dense(a, device=CPU)),
    "bell": ("uni", lambda a: jfmt.BellMatrix.from_dense(a, block_m=256),
             lambda a: tfmt.BellMatrix.from_dense(a, block_m=256,
                                                  device=CPU)),
    "binned": ("skew", lambda a: jfmt.BinnedSellMatrix.from_dense(a),
               lambda a: tfmt.BinnedSellMatrix.from_dense(a, device=CPU)),
    "asp": ("uni", lambda a: JAsp.from_dense(a, block_n=128),
            lambda a: TAsp.from_dense(a, block_n=128, device=CPU)),
}


def _same_encoding(j, t):
    """JAX encode of ``j`` and port encode of ``t``: same kind, aux, dtypes
    and bit-identical arrays."""
    jk, jaux, jdt, jarr = jio.encode(j)
    tk, taux, tdt, tarr = tio.encode(t)
    assert (jk, jaux, jdt) == (tk, taux, tdt)
    assert len(jarr) == len(tarr)
    for x, y in zip(jarr, tarr):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _product_ok(t, a):
    x = tgen.random_sparse_vector(a.shape[0], 0.5, seed=9)
    y = t.spmv(torch.from_numpy(x)).double().numpy()
    ref = x.astype(np.float64) @ a.astype(np.float64)
    # storage lanes round the values: hold them to their own dequantized A
    if isinstance(t, tfmt.SellMatrix) and t.vals.dtype != torch.float32:
        ref = x.astype(np.float64) @ t.to_dense().double().numpy()
    np.testing.assert_allclose(y, ref, atol=1e-4)


@pytest.fixture(scope="module")
def packs():
    return {name: (M[mat], jb(M[mat]), tb(M[mat]))
            for name, (mat, jb, tb) in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_file_loads_in_port(packs, tmp_path, name):
    a, j, _ = packs[name]
    path = str(tmp_path / f"{name}.npz")
    jio.save(path, j)
    t = tio.load(path, device=CPU)
    assert type(t).__name__ == type(j).__name__
    _same_encoding(j, t)
    _product_ok(t, a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_file_loads_in_jax(packs, tmp_path, name):
    _, j, t = packs[name]
    path = str(tmp_path / f"{name}.npz")
    tio.save(path, t)
    back = jio.load(path)
    assert type(back).__name__ == type(j).__name__
    _same_encoding(back, t)
    # and the port's own packer gives the JAX package's file
    _same_encoding(j, t)


def test_rsell_sorted_keeps_plan_and_unpermutes(packs, tmp_path):
    a, j, t = packs["rsell_sorted"]
    assert t.perm_plan is not None and j.perm_plan is not None
    path = str(tmp_path / "r.npz")
    tio.save(path, t)
    back = tio.load(path, device=CPU)
    np.testing.assert_array_equal(back.inv_perm, t.inv_perm)
    np.testing.assert_array_equal(back.perm_src.numpy(), t.perm_src.numpy())
    _product_ok(back, a)


def test_csr_save_load_across(tmp_path):
    a = M["skew"]
    tc, jc = TCsr.from_dense(a), JCsr.from_dense(a)
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tc.save(tp)
    jc.save(jp)
    for c in (JCsr.load(tp), TCsr.load(jp), TCsr.load(tp)):
        assert tuple(c.shape) == tuple(jc.shape)
        for f in ("row_ptr", "col_idx", "values"):
            x, y = getattr(c, f), getattr(jc, f)
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("name", ["rsell_sorted", "rsell_unsorted", "asp"])
def test_from_reference_arrays_rsell_asp(packs, name):
    a, j, t = packs[name]
    if name == "asp":
        d = dict(kind="asp", a_pad=np.asarray(j.a_pad), shape=j.shape,
                 block_n=j.block_n)
    else:
        d = dict(kind="rsell", cj=np.asarray(j.cj), ct=np.asarray(j.ct),
                 idx=np.asarray(j.idx), vals=np.asarray(j.vals),
                 shape=j.shape, padded=j.padded, nnz=j.nnz,
                 n_real=j.n_real, w_max=j.w_max, run=j.run,
                 inv_perm=j.inv_perm)
    f = from_reference_arrays(d, device=CPU)
    _same_encoding(j, f)
    _product_ok(f, a)


def _drift(tmp_path, fmt, **edit):
    path = str(tmp_path / "x.npz")
    jio.save(path, fmt)
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    d.update(edit)
    np.savez(path, **d)
    return path


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_drifted_layouts_fail_with_the_jax_messages(packs, tmp_path, pkg):
    load = jio.load if pkg == "jax" else \
        (lambda p: tio.load(p, device=CPU))
    _, j, _ = packs["sell"]
    cases = [
        (dict(meta=np.asarray(repr({"shape": (1, 1)}))), "meta is dict"),
        (dict(leaf_dtypes=np.asarray(repr(["int8"]))),
         "recorded dtypes — file layout drifted"),
        (dict(kind=np.asarray("nope")), "unknown kind 'nope'"),
        (dict(leaf2=np.zeros(3, np.float32), leaf3=np.zeros(3, np.float32),
              leaf_dtypes=np.asarray(repr(["int8", "float32", "float32",
                                          "float32"]))),
         r"sell file incompatible \(4 leaves, expected 2 or 3\)"),
    ]
    for edit, msg in cases:
        with pytest.raises(ValueError, match=msg):
            load(_drift(tmp_path, j, **edit))
    _, jr, _ = packs["rsell_unsorted"]
    with pytest.raises(ValueError, match="expected 4 or 7"):
        load(_drift(tmp_path, jr, leaf4=np.zeros(3, np.int32),
                    leaf_dtypes=np.asarray(repr(["int32", "int32", "int8",
                                                "float32", "int32"]))))


def test_older_aux_lengths_load(packs, tmp_path):
    """RSELL's 5-field aux (before ``run``) and DIA's 3- and 4-field aux
    (before ``sym`` / ``xla_only``) load as the JAX package loads them."""
    a, jr, _ = packs["rsell_unsorted"]
    aux = jr.tree_flatten()[1][:5]
    t = tio.load(_drift(tmp_path, jr, meta=np.asarray(repr(tuple(aux)))),
                 device=CPU)
    assert t.run == 1
    _product_ok(t, a)
    band, jd, _ = packs["dia"]
    for k in (3, 4):
        aux = jd.tree_flatten()[1][:k]
        path = _drift(tmp_path, jd, meta=np.asarray(repr(tuple(aux))))
        t, back = tio.load(path, device=CPU), jio.load(path)
        assert (t.sym, t.xla_only) == (back.sym, back.xla_only)
        assert t.offsets == back.offsets
