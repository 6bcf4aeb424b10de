"""K10's plain version in the port against the JAX package's K10.

``sell_dvals_plain`` stays within 1e-6 of ``sell_dvals_padded`` (Pallas
interpret mode) for B = 1, 3 and 8, in both roles the backward gives it (the
forward plane with (x, g), the transpose plane with (g, x)), on an aligned
shape, an unaligned one (x and g narrower than the packed widths, which the
port reads as 0 and JAX is handed padded) and one with empty columns and an
empty column group. Pad slots are exactly 0. The tolerance covers the JAX
interpreter's fp32 arithmetic, which need not round the multiply and the
add apart as the port does; at B = 1 both are one product and agree bit
for bit. The JAX calls are gathered in a module-scoped fixture, so each
padded shape compiles once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.autodiff import _TwinPack as JTwin
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.kernels.sell_grad import sell_dvals_padded
from tpusparse.testing import generators as jgen
from tpusparse_torch.autodiff import _TwinPack
from tpusparse_torch.formats import CsrMatrix
from tpusparse_torch.kernels.sell_grad import sell_dvals, sell_dvals_plain

ATOL_JAX = 1e-6
BATCHES = (1, 3, 8)


def _matrix(kind):
    if kind == "aligned":
        return jgen.random_sparse_matrix(256, 384, density=0.3, seed=61)
    if kind == "unaligned":
        return jgen.random_sparse_matrix(200, 300, density=0.3, seed=62)
    a = jgen.random_sparse_matrix(256, 384, density=0.3, seed=63)
    a[:, 128:256] = 0                  # an empty column group
    a[:, [3, 77, 300]] = 0             # and empty columns elsewhere
    return a


def _inputs(seed, batch, m, n):
    rng = np.random.default_rng(seed)
    x = jgen.random_sparse_batch(batch, m, 0.5, seed=seed)
    g = rng.uniform(-1, 1, (batch, n)).astype(np.float32)
    return x, g


def _pad(v, width):
    return np.pad(v, ((0, 0), (0, width - v.shape[1])))


@pytest.fixture(scope="module")
def jax_dvals():
    """Per (kind, batch): the JAX twin pack and K10 in both roles, on
    inputs padded to the packed widths."""
    out = {}
    for k, kind in enumerate(("aligned", "unaligned", "empty_cols")):
        a = _matrix(kind)
        m, n = a.shape
        jp = JTwin(JCsr.from_dense(a, use_native=False))
        mp, np_ = jp.fmt.padded
        for batch in BATCHES:
            x, g = _inputs(10 * k + batch, batch, m, n)
            xp, gp = jnp.asarray(_pad(x, mp)), jnp.asarray(_pad(g, np_))
            d = np.asarray(sell_dvals_padded(jnp.asarray(jp.s_f), xp, gp,
                                             w=jp.fmt.w))
            d_t = np.asarray(sell_dvals_padded(jnp.asarray(jp.s_t), gp, xp,
                                               w=jp.fmt_t.w))
            out[kind, batch] = (a, jp, x, g, d, d_t)
    return out


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("kind", ["aligned", "unaligned", "empty_cols"])
def test_plain_matches_jax_interpret(jax_dvals, kind, batch):
    a, jp, x, g, d, d_t = jax_dvals[kind, batch]
    jc = JCsr.from_dense(a, use_native=False)
    tp = _TwinPack(CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values))
    assert np.array_equal(tp.s_f, jp.s_f) and np.array_equal(tp.s_t, jp.s_t)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    for plane, u, v, want in ((tp.s_f, xt, gt, d), (tp.s_t, gt, xt, d_t)):
        s = torch.from_numpy(plane)
        got = sell_dvals_plain(s, u, v)
        assert got.dtype == torch.float32 and got.shape == s.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_JAX)
        if batch == 1:
            assert np.array_equal(got.numpy(), want)
        assert not got[s < 0].any()                 # pads exactly 0
        assert torch.equal(sell_dvals(s, u, v), got)  # CPU: the plain version
        wide = sell_dvals_plain(s, torch.from_numpy(
            _pad(u.numpy(), s.shape[1] * 128)), torch.from_numpy(
                _pad(v.numpy(), s.shape[0] * 128)))
        assert torch.equal(wide, got)               # narrow inputs read as 0
    if kind == "empty_cols":
        assert not d[1].any() and not d[0, :, :, [3, 77]].any()


def test_plain_matches_closed_form():
    """The formula itself, slot by slot, in float64 (no JAX)."""
    a = jgen.random_sparse_matrix(130, 260, density=0.2, seed=64)
    tp = _TwinPack(CsrMatrix.from_dense(a))
    x, g = _inputs(64, 3, 130, 260)
    got = sell_dvals_plain(torch.from_numpy(tp.s_f), torch.from_numpy(x),
                           torch.from_numpy(g)).numpy()
    nb, nt, w, _ = tp.s_f.shape
    j, t, s, r = np.nonzero(tp.s_f >= 0)
    rows, cols = t * 128 + tp.s_f[j, t, s, r], j * 128 + r
    want = (x.astype(np.float64)[:, rows] * g.astype(np.float64)[:, cols]
            ).sum(axis=0)
    np.testing.assert_allclose(got[j, t, s, r], want, rtol=0, atol=1e-6)
    assert len(rows) == a.astype(bool).sum()
    assert np.array_equal(np.sort(rows * 260 + cols),
                          np.flatnonzero(a.ravel() != 0))
    assert not got[tp.s_f < 0].any()


def test_wrapper_checks_and_device_rule():
    s = torch.zeros((1, 2, 8, 128), dtype=torch.int8)
    x, g = torch.zeros((2, 256)), torch.zeros((2, 128))
    before = sell_dvals.launches
    sell_dvals(s, x, g)                             # CPU: no launch counted
    assert sell_dvals.launches == before
    meta = [t.to("meta") for t in (s, x, g)]
    with pytest.raises(ValueError, match="CUDA"):
        sell_dvals(*meta)                           # no third device
    for bad in ((s.to("meta"), x.to("meta"), g[:1].to("meta")),
                (s.to("meta"), torch.zeros((2, 257), device="meta"),
                 g.to("meta")),
                (s.long().to("meta"), x.to("meta"), g.to("meta"))):
        with pytest.raises(ValueError, match="sell_dvals"):
            sell_dvals(*bad)
