"""Iterative solvers (``tpusparse_torch/solve.py``) against the JAX
package's, on the cases of ``tests/test_solve.py``: each solver with a
dense callable and with a port format (DIA; below n = 1024 the JAX
package runs its DIA in the XLA form, so no Pallas kernel is involved).
Iteration counts within 1 of JAX's, solutions within 1e-4 of JAX's (scaled
by the solution's size), and the float64 residual of each solution within
the solve's tolerance. BiCGStab is held so on well-conditioned systems;
on the two systems of ``tests/test_solve.py`` its fp32 count hangs on
summation order, so there it is held as ``_bicgstab_agree`` says.
``estimate_lmax`` draws its start vector from another generator than
JAX's, so both are held to scipy's λmax."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse.linalg import eigsh as sp_eigsh

from tpusparse import solve as jsolve
from tpusparse.formats.dia import DiaMatrix as JDia

from tpusparse_torch import solve as tsolve
from tpusparse_torch.formats.dia import DiaMatrix as TDia


def _laplacian_2d(side: int) -> np.ndarray:
    n = side * side
    a = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n).reshape(side, side)
    a[np.arange(n), np.arange(n)] = 4.0
    for (di, dj) in ((0, 1), (1, 0)):
        src = idx[: side - di, : side - dj].ravel()
        dst = idx[di:, dj:].ravel()
        a[src, dst] = -1.0
        a[dst, src] = -1.0
    return a


def _convection_diffusion(side: int, c: float = 0.4) -> np.ndarray:
    a = _laplacian_2d(side)
    n = side * side
    idx = np.arange(n).reshape(side, side)
    src = idx[:, : side - 1].ravel()
    a[src, src + 1] += -c          # downstream coupling only: asymmetric
    return a


def _ops(s_t: np.ndarray):
    """The operator ``v -> S v`` (``s_t`` packs ``S.T``) in both packages:
    {kind: (jax op, port op)} for a dense callable and DIA."""
    aj, at = jnp.asarray(s_t), torch.from_numpy(np.ascontiguousarray(s_t))
    return {"dense": (lambda v: v @ aj, lambda v: v @ at),
            "dia": (JDia.from_dense(s_t), TDia.from_dense(s_t, device="cpu"))}


@pytest.fixture(scope="module")
def spd():
    a = _laplacian_2d(16)                    # 256 x 256
    rng = np.random.default_rng(81)
    z_true = rng.normal(size=256).astype(np.float32)
    b = (a.astype(np.float64) @ z_true).astype(np.float32)
    return a, z_true, b, _ops(a)


@pytest.fixture(scope="module")
def nonsym():
    s = _convection_diffusion(16)
    rng = np.random.default_rng(82)
    z_true = rng.normal(size=256).astype(np.float32)
    b = (s.astype(np.float64) @ z_true).astype(np.float32)
    return s, z_true, b, _ops(np.ascontiguousarray(s.T))


@pytest.fixture(scope="module")
def nonsym_stable():
    """Convection-diffusion with a larger, varying diagonal: nonsymmetric,
    well-conditioned, and Jacobi changes it."""
    s = _convection_diffusion(16)
    s[np.arange(256), np.arange(256)] += np.linspace(1, 6, 256,
                                                     dtype=np.float32)
    rng = np.random.default_rng(86)
    z_true = rng.normal(size=256).astype(np.float32)
    b = (s.astype(np.float64) @ z_true).astype(np.float32)
    return s, z_true, b, _ops(np.ascontiguousarray(s.T))


def _agree(zj, zt, ij, it, s, b, tol, iters_slack=1, sol=1e-4, drift=1.0):
    """Port against JAX (iterations, solution) and the float64 residual:
    within ``drift`` x the solve's tolerance."""
    assert abs(int(ij["iters"]) - int(it["iters"])) <= iters_slack, \
        (int(ij["iters"]), int(it["iters"]))
    zj = np.asarray(zj, np.float64)
    zt = zt.double().numpy()
    np.testing.assert_allclose(zt, zj, atol=sol * np.abs(zj).max())
    res = np.linalg.norm(s.astype(np.float64) @ zt - b) / np.linalg.norm(b)
    assert res <= drift * tol, res


# On the convection-diffusion and the Jacobi-scaled Laplacian of
# ``tests/test_solve.py``, BiCGStab's fp32 count depends on the order in
# which its dot products are summed: relabelling the unknowns, the same
# system in exact arithmetic, moves either package's count by more than
# the two packages differ (``test_bicgstab_count_scatters_under_
# relabelling``). There a BiCGStab count is held to half of JAX's (at
# least 2), the solution to 1e-3 of JAX's, and the recurrence residual to
# ``tol`` with the true float64 residual within 100 x ``tol`` (the fp32
# recurrence drifts: 1.4 x in JAX, up to 27 x here).
def _bicgstab_agree(zj, zt, ij, it, s, b, tol):
    assert float(it["resnorm"]) <= tol * np.linalg.norm(b) * 1.01
    _agree(zj, zt, ij, it, s, b, tol,
           iters_slack=max(2, int(ij["iters"]) // 2), sol=1e-3, drift=100.0)


@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_cg(spd, kind):
    a, z_true, b, ops = spd
    jop, top = ops[kind]
    zj, ij = jsolve.cg(jop, jnp.asarray(b), tol=1e-5)
    zt, it = tsolve.cg(top, torch.from_numpy(b), tol=1e-5)
    _agree(zj, zt, ij, it, a, b, 1e-5)
    np.testing.assert_allclose(zt.numpy(), z_true, atol=5e-3)
    assert isinstance(it["iters"], int) and it["resnorm"].ndim == 0


@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_cg_jacobi(spd, kind):
    a, z_true, _, _ = spd
    d = np.exp(np.linspace(0, 4, 256)).astype(np.float32)
    a2 = (a * d[None, :]) * d[:, None]
    b2 = (a2.astype(np.float64) @ z_true).astype(np.float32)
    jop, top = _ops(np.ascontiguousarray(a2.T))[kind]
    kw = dict(tol=1e-5, maxiter=2000)
    zj, ij = jsolve.cg(jop, jnp.asarray(b2), **kw,
                       m_inv=jsolve.jacobi_preconditioner(np.diag(a2)))
    zt, it = tsolve.cg(top, torch.from_numpy(b2), **kw,
                       m_inv=tsolve.jacobi_preconditioner(np.diag(a2)))
    _agree(zj, zt, ij, it, a2, b2, 1e-5)
    _, plain = tsolve.cg(top, torch.from_numpy(b2), **kw)
    assert it["iters"] < plain["iters"]


def test_cg_maxiter_and_validation(spd):
    _, _, b, ops = spd
    top = ops["dia"][1]
    _, info = tsolve.cg(top, torch.from_numpy(b), tol=0.0, maxiter=5)
    assert info["iters"] == 5
    with pytest.raises(ValueError, match="1-D"):
        tsolve.cg(top, torch.zeros((2, 256)))


# the two systems of ``tests/test_solve.py`` take the loose hold, the
# well-conditioned one the tight hold
_BICGSTAB_HOLD = {"nonsym": _bicgstab_agree, "spd": _bicgstab_agree,
                  "nonsym_stable": _agree}


@pytest.mark.parametrize("system", ["nonsym", "nonsym_stable"])
@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_bicgstab_nonsymmetric(request, system, kind):
    s, z_true, b, ops = request.getfixturevalue(system)
    jop, top = ops[kind]
    zj, ij = jsolve.bicgstab(jop, jnp.asarray(b), tol=1e-6, maxiter=1000)
    zt, it = tsolve.bicgstab(top, torch.from_numpy(b), tol=1e-6,
                             maxiter=1000)
    _BICGSTAB_HOLD[system](zj, zt, ij, it, s, b, 1e-6)
    np.testing.assert_allclose(zt.numpy(), z_true, atol=5e-3)


@pytest.mark.parametrize("system", ["spd", "nonsym_stable"])
@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_bicgstab_preconditioned(request, system, kind):
    s, z_true, b, ops = request.getfixturevalue(system)
    jop, top = ops[kind]
    d = np.diag(s)
    zj, ij = jsolve.bicgstab(jop, jnp.asarray(b), tol=1e-6,
                             m_inv=jsolve.jacobi_preconditioner(d))
    zt, it = tsolve.bicgstab(top, torch.from_numpy(b), tol=1e-6,
                             m_inv=tsolve.jacobi_preconditioner(d))
    _BICGSTAB_HOLD[system](zj, zt, ij, it, s, b, 1e-6)
    _, plain = tsolve.bicgstab(top, torch.from_numpy(b), tol=1e-6)
    assert it["iters"] <= plain["iters"]


@pytest.mark.parametrize("case", ["nonsym", "spd_jacobi"])
def test_bicgstab_count_scatters_under_relabelling(request, case):
    """The loose hold's evidence: on these two systems, relabelling the
    unknowns (P S P^T, P b; exact arithmetic gives the same iterates)
    spreads each package's fp32 count over more than the +-1 of the tight
    hold, and the two packages differ by no more than that spread."""
    s, _, b, _ = request.getfixturevalue(
        "nonsym" if case == "nonsym" else "spd")
    d = np.diag(s) if case == "spd_jacobi" else None
    counts = {"jax": [], "port": []}
    for k in range(8):
        p = np.arange(256) if k == 0 else \
            np.random.default_rng(k).permutation(256)
        s_t = np.ascontiguousarray(s[p][:, p].T)
        aj, at = jnp.asarray(s_t), torch.from_numpy(s_t)
        jkw, tkw = ({}, {}) if d is None else (
            {"m_inv": jsolve.jacobi_preconditioner(d[p])},
            {"m_inv": tsolve.jacobi_preconditioner(d[p])})
        _, ij = jsolve.bicgstab(lambda v: v @ aj, jnp.asarray(b[p]),
                                tol=1e-6, maxiter=1000, **jkw)
        _, it = tsolve.bicgstab(lambda v: v @ at, torch.from_numpy(b[p]),
                                tol=1e-6, maxiter=1000, **tkw)
        counts["jax"].append(int(ij["iters"]))
        counts["port"].append(it["iters"])
    print(case, counts)                  # pytest -s shows the counts
    spread = {k: max(v) - min(v) for k, v in counts.items()}
    assert min(spread.values()) > 2, counts
    assert abs(counts["jax"][0] - counts["port"][0]) <= \
        max(spread.values()), counts


def test_bicgstab_maxiter_and_validation(spd):
    _, _, b, ops = spd
    top = ops["dia"][1]
    _, info = tsolve.bicgstab(top, torch.from_numpy(b), tol=0.0, maxiter=5)
    assert info["iters"] == 5
    with pytest.raises(ValueError, match="1-D"):
        tsolve.bicgstab(top, torch.zeros((2, 256)))


@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_gmres_nonsymmetric(nonsym, kind):
    s, z_true, b, ops = nonsym
    jop, top = ops[kind]
    kw = dict(tol=1e-6, restart=60, maxiter=600)
    zj, ij = jsolve.gmres(jop, jnp.asarray(b), **kw)
    zt, it = tsolve.gmres(top, torch.from_numpy(b), **kw)
    # iters counts whole cycles of 60 steps: equal counts
    _agree(zj, zt, ij, it, s, b, 1e-6, iters_slack=0)
    np.testing.assert_allclose(zt.numpy(), z_true, atol=5e-3)


@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_gmres_right_preconditioned(spd, kind):
    a, z_true, b, ops = spd
    jop, top = ops[kind]
    d = np.diag(a) * 0.25 + 3.0
    kw = dict(tol=1e-6, restart=20, maxiter=400)
    zj, ij = jsolve.gmres(jop, jnp.asarray(b), **kw,
                          m_inv=jsolve.jacobi_preconditioner(d))
    zt, it = tsolve.gmres(top, torch.from_numpy(b), **kw,
                          m_inv=tsolve.jacobi_preconditioner(d))
    _agree(zj, zt, ij, it, a, b, 1e-6, iters_slack=0)
    r = b - a @ zt.numpy()
    np.testing.assert_allclose(float(it["resnorm"]), np.linalg.norm(r),
                               rtol=0.3, atol=1e-4)


def test_gmres_maxiter_and_validation(spd):
    _, _, b, ops = spd
    top = ops["dia"][1]
    _, info = tsolve.gmres(top, torch.from_numpy(b), tol=0.0, restart=10,
                           maxiter=20)
    assert info["iters"] == 20
    with pytest.raises(ValueError, match="1-D"):
        tsolve.gmres(top, torch.zeros((2, 256)))


def test_gmres_breakdown_is_harmless():
    """An invariant subspace inside the first cycle (a diagonal operator
    with 3 distinct values): the zero basis tail must not poison the
    least-squares solve."""
    d = np.repeat(np.array([1.0, 2.0, 3.0], np.float32), 16)
    b = np.ones(48, np.float32)
    at = torch.from_numpy(np.diag(d))
    z, info = tsolve.gmres(lambda v: v @ at, torch.from_numpy(b),
                           tol=1e-6, restart=10)
    assert torch.isfinite(z).all()
    np.testing.assert_allclose(z.numpy(), 1.0 / d, rtol=1e-5)
    assert info["iters"] <= 20


@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_chebyshev_preconditioned_cg(spd, kind):
    a, z_true, b, ops = spd
    jop, top = ops[kind]
    lam = float(sp_eigsh(a.astype(np.float64), k=1, which="LA")[0][0])
    lmax_t = tsolve.estimate_lmax(top, n=256, device="cpu")
    lmax_j = jsolve.estimate_lmax(jop, n=256)
    for est in (float(lmax_t), float(lmax_j)):      # contain λmax, within
        assert lam <= est <= 1.1 * lam * (1 + 1e-6)  # the safety factor
    lmax = 1.1 * lam                      # the same bound for both packages
    zj, ij = jsolve.cg(jop, jnp.asarray(b), tol=1e-6,
                       m_inv=jsolve.chebyshev_preconditioner(jop, lmax))
    zt, it = tsolve.cg(top, torch.from_numpy(b), tol=1e-6,
                       m_inv=tsolve.chebyshev_preconditioner(top, lmax))
    _agree(zj, zt, ij, it, a, b, 1e-6)
    _, plain = tsolve.cg(top, torch.from_numpy(b), tol=1e-6)
    assert it["iters"] * 2 < plain["iters"]


@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_cg_multi_matches_single_and_jax(spd, kind):
    a, _, _, ops = spd
    jop, top = ops[kind]          # a format runs its spmm
    rng = np.random.default_rng(84)
    z_true = rng.normal(size=(4, 256)).astype(np.float32)
    b = (z_true.astype(np.float64) @ a.astype(np.float64).T) \
        .astype(np.float32)
    zj, ij = jsolve.cg_multi(jop, jnp.asarray(b), tol=1e-6)
    zt, it = tsolve.cg_multi(top, torch.from_numpy(b), tol=1e-6)
    assert it["resnorm"].shape == (4,)
    assert abs(int(ij["iters"]) - it["iters"]) <= 1
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj),
                               atol=1e-4 * np.abs(np.asarray(zj)).max())
    np.testing.assert_allclose(zt.numpy(), z_true, atol=5e-3)
    for i in range(4):
        zi, _ = tsolve.cg(top, torch.from_numpy(b[i]), tol=1e-6)
        np.testing.assert_allclose(zt[i].numpy(), zi.numpy(), atol=1e-3)


def test_cg_multi_mixed_convergence_freezes(spd):
    a, _, _, ops = spd
    top = ops["dia"][1]
    rng = np.random.default_rng(85)
    z_true = np.stack([
        1e-3 * np.eye(256, dtype=np.float32)[0],
        rng.normal(size=256).astype(np.float32),
        1e3 * rng.normal(size=256).astype(np.float32),
    ])
    b = (z_true.astype(np.float64) @ a.astype(np.float64).T) \
        .astype(np.float32)
    z, info = tsolve.cg_multi(top, torch.from_numpy(b), tol=1e-6,
                              maxiter=400)
    rel = (np.abs(z.numpy() - z_true).max(axis=1)
           / np.maximum(np.abs(z_true).max(axis=1), 1e-9))
    assert (rel < 5e-3).all()
    bn = np.linalg.norm(b, axis=1)
    assert (info["resnorm"].numpy() <= 1e-6 * bn * 1.05).all()
    with pytest.raises(ValueError, match="nrhs"):
        tsolve.cg_multi(top, torch.zeros(256))


def test_solver_keeps_the_rhs_device(spd):
    """A format and host data: the right-hand side goes to the format's
    device, and the solve stays there."""
    _, _, b, ops = spd
    top = ops["dia"][1]
    z, info = tsolve.cg(top, b, tol=1e-5)             # numpy b
    assert z.device == top.device and info["resnorm"].device == top.device
