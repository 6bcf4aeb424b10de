"""The port's pruning and graph on-ramps against the JAX package's.

``magnitude_prune``, ``nm_prune``, ``block_prune``, ``summary`` and
``normalized_adjacency`` are numpy in both packages: every result must be
the JAX package's bit for bit (``shape``, ``row_ptr``, ``col_idx`` and
``values``, dtypes included), and each guard must refuse the same inputs.
A tensor weight prunes as its numpy copy does. The normalized adjacency
then runs as ``linear_map``'s frozen operator (example 12's use), with dx
against the float64 oracle.
"""

import numpy as np
import pytest
import torch

from tpusparse import graph as jgraph
from tpusparse import prune as jprune
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.testing import generators as jgen
from tpusparse_torch import (CsrMatrix, SellMatrix, block_prune, linear_map,
                             magnitude_prune, nm_prune, normalized_adjacency)
from tpusparse_torch import prune as tprune


def _same_csr(u, v):
    assert tuple(u.shape) == tuple(v.shape)
    for k in ("row_ptr", "col_idx", "values"):
        a, b = np.asarray(getattr(u, k)), np.asarray(getattr(v, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def _weight(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


CASES = [
    ("magnitude", dict(density=0.3), (256, 384)),
    ("magnitude", dict(density=0.1, per_column=False), (200, 300)),
    ("magnitude", dict(density=1.0), (64, 96)),
    ("nm", dict(n_keep=2, m_group=4), (256, 384)),
    ("nm", dict(n_keep=1, m_group=8), (128, 200)),
    ("block", dict(density=0.25), (512, 384)),
    ("block", dict(density=0.5, block_m=64, block_n=32), (200, 300)),
]


@pytest.mark.parametrize("kind,kw,shape", CASES)
def test_prune_matches_jax(kind, kw, shape):
    a = _weight(*shape, seed=len(CASES) + shape[0])
    a[:, 5] = 0.0                                  # an all-zero column
    fn = {"magnitude": "magnitude_prune", "nm": "nm_prune",
          "block": "block_prune"}[kind]
    got, want = getattr(tprune, fn)(a, **kw), getattr(jprune, fn)(a, **kw)
    assert isinstance(got, CsrMatrix)
    _same_csr(got, want)
    _same_csr(getattr(tprune, fn)(torch.from_numpy(a), **kw), got)
    assert tprune.summary(got) == jprune.summary(want)


def test_prune_guards_match_jax():
    a = _weight(100, 64, seed=1)
    calls = [("magnitude_prune", (a, 0.0), {}),
             ("magnitude_prune", (a, 1.5), {}),
             ("nm_prune", (a,), dict(n_keep=3, m_group=2)),
             ("nm_prune", (a,), dict(n_keep=2, m_group=8)),   # 100 % 8
             ("block_prune", (a, 0.0), {}),
             ("magnitude_prune", (a[0], 0.5), {})]            # not 2-D
    for fn, args, kw in calls:
        for mod in (tprune, jprune):
            with pytest.raises(ValueError):
                getattr(mod, fn)(*args, **kw)
    assert magnitude_prune is tprune.magnitude_prune
    assert (nm_prune, block_prune) == (tprune.nm_prune, tprune.block_prune)


def _graph(n, seed, isolated=()):
    """An undirected random graph with weights, some self-loops and some
    isolated nodes, as the CSR of A.T (symmetric, so that is A)."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.05) * rng.uniform(0.5, 2.0, (n, n))
    a = np.triu(a, 1)
    a = a + a.T
    a[np.arange(0, n, 7), np.arange(0, n, 7)] = 1.5
    for i in isolated:
        a[i, :] = a[:, i] = 0.0
    return a.astype(np.float32)


@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("n,isolated", [(300, ()), (256, (3, 100, 255))])
def test_normalized_adjacency_matches_jax(n, isolated, self_loops):
    a = _graph(n, seed=n, isolated=isolated)
    jc = JCsr.from_dense(a, use_native=False)
    c = CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values)
    got = normalized_adjacency(c, add_self_loops=self_loops)
    _same_csr(got, jgraph.normalized_adjacency(jc,
                                               add_self_loops=self_loops))
    _same_csr(normalized_adjacency(c, add_self_loops=self_loops,
                                   dtype=np.float64),
              jgraph.normalized_adjacency(jc, add_self_loops=self_loops,
                                          dtype=np.float64))
    with pytest.raises(ValueError, match="square"):
        normalized_adjacency(CsrMatrix.from_dense(a[:, :-1]))


def test_gcn_layer_through_linear_map():
    """Example 12's operator as linear_map's frozen map: y = x @ A_hat,
    dx = g @ A_hat.T, both against the float64 oracle."""
    a = _graph(300, seed=9)
    ahat = normalized_adjacency(CsrMatrix.from_dense(a))
    f = linear_map(SellMatrix.from_csr(ahat, device="cpu"), csr=ahat)
    dense = ahat.to_dense().astype(np.float64)
    h = torch.from_numpy(jgen.random_sparse_batch(4, 300, 0.5,
                                                  seed=10)).requires_grad_()
    t = torch.from_numpy(np.random.default_rng(11).uniform(
        -1, 1, (4, 300)).astype(np.float32))
    y = f(h)
    np.testing.assert_allclose(y.detach().numpy(),
                               h.detach().double().numpy() @ dense, rtol=0,
                               atol=1e-5)
    (y * t).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(), t.double().numpy() @ dense.T,
                               rtol=0, atol=1e-5)
