"""Lanczos (``tpusparse_torch/eig.py``) against the JAX package's and
scipy: with an explicit ``v0`` the projection ``T`` and the basis within
1e-4 of JAX's; ``eigsh`` and ``spectrum_bounds`` against scipy's float64
eigenvalues (their default start vector is the port's own draw)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse import eig as jeig
from tpusparse.formats.dia import DiaMatrix as JDia

from tpusparse_torch import eig as teig
from tpusparse_torch import solve as tsolve
from tpusparse_torch.formats.dia import DiaMatrix as TDia


def _spd(n: int, seed: int = 3, cond: float = 50.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.geomspace(1.0, cond, n)
    return ((q * lam) @ q.T).astype(np.float32)


@pytest.fixture(scope="module")
def spd256():
    a = _spd(256)
    return a, np.linalg.eigvalsh(a.astype(np.float64))


@pytest.fixture(scope="module")
def lap():
    """The 16 x 16 Dirichlet 5-point Laplacian of ``tests/test_eig.py`` as
    DIA in both packages (at n = 256 the JAX package runs its XLA form)."""
    side = 16
    n = side * side
    a = np.zeros((n, n), np.float32)
    idx = np.arange(n).reshape(side, side)
    a[np.arange(n), np.arange(n)] = 4.0
    for (di, dj) in ((0, 1), (1, 0)):
        src = idx[: side - di, : side - dj].ravel()
        dst = idx[di:, dj:].ravel()
        a[src, dst] = -1.0
        a[dst, src] = -1.0
    lam = np.linalg.eigvalsh(a.astype(np.float64))
    return a, lam, JDia.from_dense(a), TDia.from_dense(a, device="cpu")


def test_lanczos_matches_jax_with_v0(spd256):
    a, _ = spd256
    v0 = np.random.default_rng(1).normal(size=256).astype(np.float32)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    tj, vj = jeig.lanczos(aj.__matmul__, 24, v0=jnp.asarray(v0))
    tt, vt = teig.lanczos(at.__matmul__, 24, v0=torch.from_numpy(v0))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)
    g = vt.numpy() @ vt.numpy().T
    np.testing.assert_allclose(g, np.eye(24), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), vt.numpy() @ a @ vt.numpy().T,
                               atol=1e-3)


def test_lanczos_on_dia_matches_jax(lap):
    a, _, jd, td = lap
    v0 = np.random.default_rng(2).normal(size=256).astype(np.float32)
    tj, vj = jeig.lanczos(jd, 32, v0=jnp.asarray(v0))
    tt, vt = teig.lanczos(td, 32, v0=torch.from_numpy(v0))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)


def test_eigsh_extremal_values(spd256):
    a, lam = spd256
    op = torch.from_numpy(a).__matmul__
    evals, evecs, resid = teig.eigsh(op, k=3, which="LA", ncv=40, n=256)
    np.testing.assert_allclose(evals.numpy()[-1], lam[-1], rtol=2e-3)
    assert float(resid[-1]) < 1e-2 * lam[-1]
    v = evecs.numpy()[-1]
    np.testing.assert_allclose(a @ v, float(evals[-1]) * v,
                               atol=2e-2 * lam[-1])


def test_eigsh_sa_and_be(spd256):
    a, lam = spd256
    op = torch.from_numpy(a).__matmul__
    lo, _, _ = teig.eigsh(op, k=2, which="SA", ncv=64, n=256)
    assert abs(float(lo[0]) - lam[0]) < 0.2 * lam[0]
    be, vecs, _ = teig.eigsh(op, k=2, which="BE", ncv=64, n=256,
                             return_vectors=False)
    assert vecs is None and float(be[0]) < float(be[-1])
    np.testing.assert_allclose(float(be[-1]), lam[-1], rtol=2e-3)


def test_eigsh_validation(spd256):
    op = torch.from_numpy(spd256[0]).__matmul__
    with pytest.raises(ValueError, match="which"):
        teig.eigsh(op, which="LM", n=256)
    with pytest.raises(ValueError, match="k <= ncv"):
        teig.eigsh(op, k=30, ncv=10, n=256)


def test_spectrum_bounds_contain_and_drive_chebyshev(lap):
    a, lam, _, td = lap
    lmin, lmax = teig.spectrum_bounds(td, ncv=48)
    assert float(lmin) <= lam[0] * 1.05 and float(lmax) >= lam[-1] * 0.999
    assert float(lmax) <= 1.05 * lam[-1]
    assert float(lmin) > 0.25 * lam[0]          # not a trivial lower bound
    b = np.random.default_rng(5).normal(size=256).astype(np.float32)
    m_inv = tsolve.chebyshev_preconditioner(td, lmax, lmin=lmin, degree=8)
    z, info = tsolve.cg(td, torch.from_numpy(b), tol=1e-5, m_inv=m_inv)
    assert info["iters"] <= 14
    np.testing.assert_allclose(td.spmv(z).numpy(), b, atol=1e-3)


def test_spectrum_bounds_jax_and_port_both_contain(lap):
    """Different start vectors (the JAX PRNG, a torch generator): each
    package's interval must contain the float64 spectrum's top."""
    _, lam, jd, td = lap
    _, lmax_j = jeig.spectrum_bounds(jd, ncv=32)
    _, lmax_t = teig.spectrum_bounds(td, ncv=32)
    for v in (float(lmax_j), float(lmax_t)):
        assert lam[-1] <= v <= 1.05 * lam[-1]
