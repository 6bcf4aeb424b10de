"""RCM reordering (``tpusparse_torch/reorder.py``) against the JAX
package's, on the cases of ``tests/test_reorder.py``: the permutations,
reordered CSRs, bandwidths and ``banded_after_rcm`` decisions bit for bit,
and the two-space CG through the port's DIA."""

import numpy as np
import pytest
import torch

from tpusparse import reorder as jre
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.testing import generators as jgen

from tpusparse_torch import reorder as tre
from tpusparse_torch.formats.auto import auto_format
from tpusparse_torch.formats.csr import CsrMatrix as TCsr
from tpusparse_torch.formats.dia import DiaMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.solve import cg
from tpusparse_torch.testing import generators as tgen


def _scrambled_banded(n=1024, bandwidth=6, seed=11):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    for k in range(-bandwidth, bandwidth + 1):
        d = rng.uniform(0.2, 1.0, n - abs(k)).astype(np.float32)
        a += np.diag(d if k else d + 2.0 * bandwidth, k)
    p = rng.permutation(n)
    return np.ascontiguousarray(a[np.ix_(p, p)]), a


def _sym(seed):
    s, _ = _scrambled_banded(seed=seed)
    return np.ascontiguousarray((s + s.T) / 2)


def _bits(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert x.tobytes() == y.tobytes()


def _same_csr(j, t):
    assert tuple(j.shape) == tuple(t.shape)
    for f in ("row_ptr", "col_idx", "values"):
        _bits(getattr(j, f), getattr(t, f))


CASES = {
    "scrambled_band_11": lambda: _scrambled_banded(seed=11)[0],
    "scrambled_band_12": lambda: _scrambled_banded(seed=12)[0],
    "scrambled_sym_14": lambda: _sym(14),
    "uniform": lambda: jgen.random_sparse_csr(512, 512, density=0.05,
                                              seed=16),
    "chain_scrambled": None,
}


def _csrs(name):
    if name == "uniform":
        j = CASES[name]()
        t = tgen.random_sparse_csr(512, 512, density=0.05, seed=16)
        return j, t
    if name == "chain_scrambled":
        c = tgen.stencil_csr((4096,))
        p = np.random.default_rng(3).permutation(4096)
        sp = c.to_scipy().tocsr()[p][:, p]
        return JCsr.from_scipy(sp), TCsr.from_scipy(sp)
    a = CASES[name]()
    return JCsr.from_dense(a), TCsr.from_dense(a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rcm_bits_match_jax(name):
    jc, tc = _csrs(name)
    _same_csr(jc, tc)
    assert jre.bandwidth_csr(jc) == tre.bandwidth_csr(tc)
    jb, jp = jre.rcm(jc)
    tb, tp = tre.rcm(tc)
    _bits(jp, tp)
    _same_csr(jb, tb)
    assert jre.bandwidth_csr(jb) == tre.bandwidth_csr(tb)
    jg, tg = jre.banded_after_rcm(jc), tre.banded_after_rcm(tc)
    assert (jg is None) == (tg is None)
    if jg is not None:
        _bits(jg[1], tg[1])
        _same_csr(jg[0], tg[0])
    assert (tg is None) == (name == "uniform")


def test_rcm_recovers_band_and_routes_to_dia():
    scrambled, _ = _scrambled_banded()
    csr = TCsr.from_dense(scrambled)
    assert tre.bandwidth_csr(csr) > 500
    csr_b, p = tre.rcm(csr)
    assert tre.bandwidth_csr(csr_b) <= 40 and csr_b.nnz == csr.nnz
    assert isinstance(auto_format(csr_b, device="cpu"), DiaMatrix)
    np.testing.assert_array_equal(csr_b.to_dense(), scrambled[np.ix_(p, p)])


def test_two_space_spmv_matches_direct():
    scrambled, _ = _scrambled_banded(seed=12)
    csr = TCsr.from_dense(scrambled)
    csr_b, p = tre.rcm(csr)
    fmt_b = auto_format(csr_b, device="cpu")
    x = np.random.default_rng(13).normal(size=csr.shape[0]) \
        .astype(np.float32)
    y_direct = SellMatrix.from_csr(csr, device="cpu").spmv(
        torch.from_numpy(x)).numpy()
    y_b = fmt_b.spmv(tre.permute_vector(torch.from_numpy(x), p))
    np.testing.assert_allclose(tre.unpermute_vector(y_b, p).numpy(),
                               y_direct, atol=1e-3)
    # numpy in, numpy out; tensors in, tensors out
    assert isinstance(tre.permute_vector(x, p), np.ndarray)


def test_cg_in_permuted_space():
    sym = _sym(14)
    csr = TCsr.from_dense(sym)
    csr_b, p = tre.banded_after_rcm(csr)
    fmt = auto_format(csr_b, device="cpu")
    assert isinstance(fmt, DiaMatrix)
    rng = np.random.default_rng(15)
    z_true = rng.normal(size=csr.shape[0]).astype(np.float32)
    b = torch.from_numpy((sym.astype(np.float64) @ z_true)
                         .astype(np.float32))
    z_b, info = cg(fmt, tre.permute_vector(b, p), tol=1e-6)
    z = tre.unpermute_vector(z_b, p)
    np.testing.assert_allclose(z.numpy(), z_true, atol=5e-3)
    assert info["iters"] < csr.shape[0]


def test_validation_and_inverse():
    with pytest.raises(ValueError, match="square"):
        tre.rcm(TCsr.from_dense(np.ones((4, 8), np.float32)))
    p = np.random.default_rng(17).permutation(64)
    v = np.arange(64)
    np.testing.assert_array_equal(
        tre.unpermute_vector(tre.permute_vector(v, p), p), v)
    _bits(tre.inverse_permutation(p), jre.inverse_permutation(p))
