"""Cross-format fuzz of the port on the CPU: random shapes, densities and
distributions (the case generator of ``tests/test_fuzz.py``, copied: seed
2026, 6 cases) through every format's plain kernels.

- spmv and spmm meet the float64 oracle at the repo's 1e-3, and
  ``to_dense`` round-trips exactly, for SELL, AWSP, RSELL, ASP, BSR, TCSR,
  ELL, BELL and binned SELL; DIA on the banded cases and a small 2D
  stencil (it packs every diagonal, so an unstructured matrix is not its
  input).
- ``trainable_linear``'s forward, dx and value gradients meet the float64
  oracle on two cases.
- The formats the JAX fuzz covers (sell, awsp, bsr, ell, bell, binned,
  asp) match the JAX package within 1e-4 on two cases each; those JAX
  calls (Pallas interpret mode, ~1 s each) run once, in a module-scoped
  fixture.
"""

import numpy as np
import pytest
import torch

from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch import trainable_linear
from tpusparse_torch.formats import (AspMatrix, AwspMatrix, BellMatrix,
                                     BinnedSellMatrix, BsrMatrix, CsrMatrix,
                                     DiaMatrix, EllMatrix, RsellMatrix,
                                     SellMatrix, TcsrMatrix)
from tpusparse_torch.testing import generators

ATOL = 1e-3
ATOL_JAX = 1e-4
CPU = torch.device("cpu")
PORT = {
    "sell": lambda a: SellMatrix.from_dense(a, device=CPU),
    "awsp": lambda a: AwspMatrix.from_dense(a, g=2, device=CPU),
    "rsell": lambda a: RsellMatrix.from_dense(a, device=CPU),
    "asp": lambda a: AspMatrix.from_dense(a, block_n=128, device=CPU),
    "bsr": lambda a: BsrMatrix.from_dense(a, block_m=128, device=CPU),
    "tcsr": lambda a: TcsrMatrix.from_dense(a, device=CPU),
    "ell": lambda a: EllMatrix.from_dense(a, device=CPU),
    "bell": lambda a: BellMatrix.from_dense(a, block_m=128, device=CPU),
    "binned": lambda a: BinnedSellMatrix.from_dense(a, device=CPU),
}
JAX_FORMATS = ["sell", "awsp", "bsr", "ell", "bell", "binned", "asp"]


def _jax_pack(name, a):
    if name == "sell":
        from tpusparse.formats.sell import SellMatrix as J
        return J.from_dense(a)
    if name == "awsp":
        from tpusparse.formats.awsp import AwspMatrix as J
        return J.from_dense(a, g=2)
    if name == "bsr":
        from tpusparse.formats.bsr import BsrMatrix as J
        return J.from_dense(a, block_m=128)
    if name == "ell":
        from tpusparse.formats.ell import EllMatrix as J
        return J.from_dense(a)
    if name == "bell":
        from tpusparse.formats.bell import BellMatrix as J
        return J.from_dense(a, block_m=128)
    if name == "binned":
        from tpusparse.formats.binned import BinnedSellMatrix as J
        return J.from_dense(a)
    from tpusparse.kernels.asp_spmv import AspMatrix as J
    return J.from_dense(a, block_n=128)


def _cases(n_cases=6):
    rng = np.random.default_rng(2026)
    for _ in range(n_cases):
        m = int(rng.integers(1, 5)) * 64 + int(rng.integers(0, 64))
        n = int(rng.integers(1, 4)) * 64 + int(rng.integers(0, 64))
        density = float(rng.choice([0.05, 0.2, 0.5, 0.9]))
        dist = str(rng.choice(["uniform", "powerlaw", "banded", "blocks"]))
        seed = int(rng.integers(0, 10000))
        yield m, n, density, dist, seed


CASES = list(_cases())


def _case(k):
    m, n, density, dist, seed = CASES[k]
    a = jgen.random_sparse_matrix(m, n, density=density, seed=seed,
                                  distribution=dist)
    x = jgen.random_sparse_vector(m, density=0.5, seed=seed + 1)
    b = int(np.random.default_rng(seed).integers(2, 7))
    xb = jgen.random_sparse_batch(b, m, density=0.5, seed=seed + 2)
    return a, x, xb, f"[{m}x{n} d={density} {dist} s={seed}]"


def _check(f, a, x, xb, label):
    np.testing.assert_allclose(f.spmv(x).numpy(), reference.sgemv_cpu(x, a),
                               rtol=0, atol=ATOL, err_msg=label)
    np.testing.assert_allclose(f.spmm(xb).numpy(),
                               reference.sgemm_cpu(xb, a), rtol=0, atol=ATOL,
                               err_msg=label)
    if hasattr(f, "to_dense"):
        np.testing.assert_array_equal(np.asarray(f.to_dense()), a,
                                      err_msg=label)


@pytest.fixture(scope="module")
def jax_fuzz():
    """The JAX package's spmv on the first two cases: {(fmt, k): y}."""
    return {(name, k): np.asarray(_jax_pack(name, _case(k)[0])
                                  .spmv(_case(k)[1]), np.float64)
            for name in JAX_FORMATS for k in range(2)}


@pytest.mark.parametrize("fmt", list(PORT))
def test_fuzz_spmv_spmm(fmt):
    for k in range(len(CASES)):
        a, x, xb, label = _case(k)
        _check(PORT[fmt](a), a, x, xb, fmt + label)


@pytest.mark.parametrize("fmt", JAX_FORMATS)
def test_fuzz_matches_jax(jax_fuzz, fmt):
    for k in range(2):
        a, x, _, label = _case(k)
        y = PORT[fmt](a).spmv(x).numpy()
        np.testing.assert_allclose(y, jax_fuzz[fmt, k], rtol=0,
                                   atol=ATOL_JAX, err_msg=fmt + label)


def test_fuzz_dia():
    banded = [k for k, c in enumerate(CASES) if c[3] == "banded"]
    assert banded, "the generator drew no banded case"
    for k in banded:
        a, x, xb, label = _case(k)
        _check(DiaMatrix.from_dense(a, device=CPU), a, x, xb, "dia" + label)
    csr = generators.stencil_csr((12, 20))
    a = csr.to_dense()
    d = DiaMatrix.from_csr(csr, device=CPU)
    assert d.sym
    x = jgen.random_sparse_vector(240, 0.5, seed=3)
    xb = jgen.random_sparse_batch(3, 240, 0.5, seed=4)
    _check(d, a, x, xb, "dia[stencil 12x20]")


def _slots_to_dense(s, v, m, n):
    """float64 dense (m, n) from values ``v`` laid out as the signed plane
    ``s``: slot (j, t, _, r) holds entry (t*128 + s, j*128 + r)."""
    live = s >= 0
    j, t, _, r = torch.nonzero(live, as_tuple=True)
    d = torch.zeros((s.shape[1] * 128, s.shape[0] * 128), dtype=torch.float64)
    d[t * 128 + s[live].long(), j * 128 + r] = v[live].double()
    return d[:m, :n]


@pytest.mark.parametrize("k", [0, 1])
def test_fuzz_trainable_linear(k):
    a, _, xb, label = _case(k)
    m, n = a.shape
    apply, params, masks, _ = trainable_linear(CsrMatrix.from_dense(a),
                                               device=CPU)
    x = torch.from_numpy(xb).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(k).uniform(
        -1, 1, (xb.shape[0], n)).astype(np.float32))
    y = apply(params, x)
    np.testing.assert_allclose(y.detach().numpy(), reference.sgemm_cpu(xb, a),
                               rtol=0, atol=ATOL, err_msg=label)
    y.backward(g)
    a64, x64, g64 = (torch.from_numpy(v).double() for v in (a, xb, g.numpy()))
    np.testing.assert_allclose(x.grad.double().numpy(), (g64 @ a64.T).numpy(),
                               rtol=0, atol=ATOL, err_msg=label)
    da = (x64.T @ g64) * (a64 != 0)
    st = apply.statics
    for key, plane, want in (("vals", st["s_f"], da), ("vals_t", st["s_t"],
                                                       da.T)):
        got = _slots_to_dense(plane, params[key].grad, *want.shape)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL, err_msg=key + label)
        assert int(params[key].grad[~masks[key]].count_nonzero()) == 0
