"""Smoothed-aggregation AMG (``tpusparse_torch/amg.py``) against the JAX
package: the host hierarchy (aggregates, prolongators, Galerkin
operators, lmax, dinv, coarse inverse) bit for bit through the packed
levels' encodings, in greedy, block and grid modes, with ``auto`` theta
and on an unstructured ``mesh_csr`` operator; the port's V-cycle on the
CPU against a float64 scipy V-cycle built from the same host matrices;
JAX's V-cycle and solve in grid mode on a 31 x 31 lattice; and
checkpoints across the two packages in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse import amg as jamg
from tpusparse.formats import io as jio
from tpusparse.testing import generators as jgen

from tpusparse_torch import amg as tamg
from tpusparse_torch.formats import io as tio
from tpusparse_torch.testing import generators as tgen

CPU = "cpu"

# name -> (operator from a generators module, kwargs)
CASES = {
    "lap48_greedy": (lambda g: g.stencil_csr((48, 48)), {}),
    "mesh_greedy": (lambda g: g.mesh_csr(40, 40, seed=3),
                    dict(dense_cutoff=256, coarse_size=100)),
    "aniso_auto_theta": (lambda g: g.stencil_csr((64, 64), eps=100.0),
                         dict(coarse_size=100)),
    "chain_block": (lambda g: g.stencil_csr((4096,)), {}),
    "grid31": (lambda g: g.stencil_csr((31, 31)),
               dict(aggregation="grid", dense_cutoff=200)),
}


@pytest.fixture(scope="module")
def built():
    """{case: (port CsrMatrix, JAX hierarchy, port hierarchy, host)}."""
    out = {}
    for name, (make, kw) in CASES.items():
        c = make(tgen)
        j = jamg.smoothed_aggregation(make(jgen), **kw)
        t = tamg.smoothed_aggregation(c, device=CPU, **kw)
        host = tamg.host_hierarchy(
            c, **{k: v for k, v in kw.items() if k != "dense_cutoff"})
        out[name] = (c, j, t, host)
    return out


def _bits(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert x.tobytes() == y.tobytes()


def _same_component(jo, to):
    if jo is None:
        assert to is None
    elif isinstance(jo, (jax.Array, np.ndarray)):
        assert isinstance(to, torch.Tensor)
        _bits(jo, to.numpy())
    else:
        jk, jaux, jdt, jarr = jio.encode(jo)
        tk, taux, tdt, tarr = tio.encode(to)
        assert (jk, jaux, jdt) == (tk, taux, tdt)
        for x, y in zip(jarr, tarr, strict=True):
            _bits(x, y)


def _same_hierarchy(j, t):
    assert len(j.levels) == len(t.levels)
    assert (j.theta, j.degree, j.ratio, j.omega) == \
        (t.theta, t.degree, t.ratio, t.omega)
    for jl, tl in zip(j.levels, t.levels):
        assert (jl.n, jl.nnz, jl.fmt, jl.kind, jl.shape2d) == \
            (tl.n, tl.nnz, tl.fmt, tl.kind, tl.shape2d)
        assert (jl.lmax is None) == (tl.lmax is None)
        if jl.lmax is not None:
            assert float(jl.lmax) == tl.lmax
        for name in ("a", "p", "pt", "dinv"):
            _same_component(getattr(jl, name), getattr(tl, name))
    _bits(j.coarse_inv, t.coarse_inv.numpy())


@pytest.mark.parametrize("nx,ny,seed", [(24, 24, 9), (40, 40, 3),
                                        (17, 33, 0)])
def test_mesh_csr_bits(nx, ny, seed):
    j, t = jgen.mesh_csr(nx, ny, seed=seed), tgen.mesh_csr(nx, ny, seed=seed)
    assert tuple(j.shape) == tuple(t.shape)
    for f in ("row_ptr", "col_idx", "values"):
        _bits(getattr(j, f), getattr(t, f))


@pytest.mark.parametrize("name", sorted(CASES))
def test_hierarchy_bits_match_jax(built, name):
    _, j, t, _ = built[name]
    _same_hierarchy(j, t)
    assert repr(j).split("levels=")[1] == repr(t).split("levels=")[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_steps_match_jax(built, name):
    """Each level's aggregates, lmax, lattice stride and auto theta, from
    the JAX package's own host functions on the port's level operators."""
    _, j, _, (levels, coarse, theta) = built[name]
    assert theta == j.theta
    for h in levels:
        assert jamg._detect_grid(h.sp) == tamg._detect_grid(h.sp)
        assert jamg._auto_theta(h.sp) == tamg._auto_theta(h.sp)
        assert jamg._lmax_dinv_a(h.sp, h.dinv) == h.lmax
        if h.kind == "packed":
            th = tamg._auto_theta(h.sp) if CASES[name][1].get(
                "theta", "auto") == "auto" else CASES[name][1]["theta"]
            agg, n_agg = jamg._aggregate(h.sp, th, use_native=False)
            _bits(agg, h.agg)
            assert n_agg == h.n_agg
    assert coarse.shape[0] == j.levels[-1].n


def test_modes_engage(built):
    kinds = {name: built[name][2].levels[0].kind for name in CASES}
    assert kinds == {"lap48_greedy": "packed", "mesh_greedy": "packed",
                     "aniso_auto_theta": "packed", "chain_block": "block",
                     "grid31": "grid"}
    assert built["aniso_auto_theta"][2].theta > 0.0
    mesh = built["mesh_greedy"][2]
    assert type(mesh.levels[0].p).__name__ == "RsellMatrix"
    assert type(mesh.levels[0].a).__name__ == "TcsrMatrix"


def _reference_vcycle(host, amg, r):
    """The V-cycle in float64 with scipy, from the host matrices."""
    levels, coarse, _ = host
    inv = np.linalg.inv(coarse.toarray())

    def smooth(h, r):
        lmax, lmin = 1.05 * h.lmax, h.lmax / amg.ratio
        theta, delta = (lmax + lmin) / 2, (lmax - lmin) / 2
        sigma = theta / delta
        v = h.dinv * r
        rho = 1 / sigma
        d = v / theta
        z = d.copy()
        res = v - h.dinv * (h.sp @ z)
        for _ in range(amg.degree - 1):
            rho_new = 1 / (2 * sigma - rho)
            d = rho_new * rho * d + 2 * rho_new / delta * res
            z = z + d
            res = res - h.dinv * (h.sp @ d)
            rho = rho_new
        return z

    def cycle(li, r):
        if li == len(levels):
            return inv @ r
        h = levels[li]
        x = smooth(h, r)
        x = x + h.p @ cycle(li + 1, h.p.T @ (r - h.sp @ x))
        return x + smooth(h, r - h.sp @ x)

    return cycle(0, r)


@pytest.mark.parametrize("name", sorted(CASES))
def test_vcycle_matches_float64_scipy(built, name):
    c, _, t, host = built[name]
    r = np.random.default_rng(31).normal(size=c.shape[0])
    z = t(torch.from_numpy(r.astype(np.float32))).double().numpy()
    ref = _reference_vcycle(host, t, r.astype(np.float32).astype(np.float64))
    assert np.linalg.norm(z - ref) <= 1e-5 * np.linalg.norm(ref)


def test_grid_vcycle_and_solve_match_jax(built):
    c, j, t, _ = built["grid31"]
    b = np.random.default_rng(11).normal(size=c.shape[0]).astype(np.float32)
    vj = np.asarray(j(jnp.asarray(b)), np.float64)
    vt = t(torch.from_numpy(b)).double().numpy()
    assert np.linalg.norm(vt - vj) <= 1e-4 * np.linalg.norm(vj)
    zj, ij = j.solve(jnp.asarray(b), tol=1e-5)
    zt, it = t.solve(torch.from_numpy(b), tol=1e-5)
    assert abs(it["iters"] - int(ij["iters"])) <= 1
    zj = np.asarray(zj, np.float64)
    np.testing.assert_allclose(zt.double().numpy(), zj,
                               atol=1e-4 * np.abs(zj).max())
    sp = c.to_scipy().astype(np.float64)
    res = np.linalg.norm(sp @ zt.double().numpy() - b) / np.linalg.norm(b)
    assert res <= 1e-4


@pytest.mark.parametrize("name", ["lap48_greedy", "chain_block",
                                  "mesh_greedy"])
def test_solve_converges(built, name):
    c, _, t, _ = built[name]
    b = np.random.default_rng(7).normal(size=c.shape[0]).astype(np.float32)
    z, info = t.solve(torch.from_numpy(b), tol=1e-5)
    assert info["iters"] <= 20
    assert float(info["resnorm"]) <= 1e-5 * np.linalg.norm(b) * 1.01
    sp = c.to_scipy().astype(np.float64)
    res = np.linalg.norm(sp @ z.double().numpy() - b) / np.linalg.norm(b)
    assert res <= 1e-4


@pytest.mark.parametrize("name", ["lap48_greedy", "grid31", "chain_block",
                                  "mesh_greedy"])
def test_checkpoints_cross_both_ways(built, tmp_path, name):
    c, j, t, _ = built[name]
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t.save(tp)
    j.save(jp)
    _same_hierarchy(jamg.SmoothedAggregationAMG.load(tp), t)
    back = tamg.SmoothedAggregationAMG.load(jp, device=CPU)
    _same_hierarchy(j, back)
    mine = tamg.SmoothedAggregationAMG.load(tp, device=CPU)
    _same_hierarchy(j, mine)
    r = torch.from_numpy(np.random.default_rng(5).normal(
        size=c.shape[0]).astype(np.float32))
    assert torch.equal(mine(r), t(r)) and torch.equal(back(r), t(r))
    with pytest.raises(ValueError, match="checkpoint"):
        np.savez(str(tmp_path / "junk.npz"), x=np.zeros(3))
        tamg.SmoothedAggregationAMG.load(str(tmp_path / "junk.npz"),
                                         device=CPU)


def test_validation():
    with pytest.raises(ValueError, match="square"):
        tamg.smoothed_aggregation(np.ones((4, 8), np.float32), device=CPU)
    bad = np.array([[2.0, 1.0], [0.0, 2.0]], np.float32)
    with pytest.raises(ValueError, match="symmetric"):
        tamg.smoothed_aggregation(bad, device=CPU)
    with pytest.raises(ValueError, match="aggregation"):
        tamg.smoothed_aggregation(tgen.stencil_csr((8, 8)),
                                  aggregation="pairwise", device=CPU)
    with pytest.raises(ValueError, match="stalled"):
        tamg.smoothed_aggregation(tgen.stencil_csr((96, 96)), theta=0.9,
                                  device=CPU)
    with pytest.raises(ValueError, match="lattice"):
        tamg.smoothed_aggregation(tgen.mesh_csr(16, 16), aggregation="grid",
                                  coarse_size=64, device=CPU)


def test_gpu_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamg.smoothed_aggregation(tgen.stencil_csr((8, 8)))
