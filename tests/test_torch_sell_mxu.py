"""K11's plain version (SELL decompress-to-dense SpMM) against the JAX
package's K11 in Pallas interpret mode, on the case of
``tests/test_sparse_kernels.py``: 384 x 256, d = 0.2, with row 0 set to 1
so every column holds an offset-0 entry that the pad slots (index 0, value
0) alias. B in {1, 3, 8}: within 1e-4 of the JAX kernel (split-bf16
products, ~3e-5 off fp32) and 1e-5 of the float64 oracle. The JAX calls
(~1 s each here) run once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

from tpusparse.formats.sell import SellMatrix as JSell
from tpusparse.kernels.sell_mxu_spmm import sell_mxu_spmm_padded
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch.formats import SellMatrix
from tpusparse_torch.kernels.sell_mxu_spmm import (sell_mxu_spmm,
                                                   sell_mxu_spmm_plain)

BATCHES = (1, 3, 8)


def _matrix():
    a = jgen.random_sparse_matrix(384, 256, density=0.2, seed=61)
    a[0, :] = 1.0          # c = 0 entries in every column: pad collision bait
    return a


def _x(b):
    return jgen.random_sparse_batch(b, 384, density=0.5, seed=61)


@pytest.fixture(scope="module")
def jax_mxu():
    s = JSell.from_dense(_matrix())
    return {b: np.asarray(sell_mxu_spmm_padded(s.idx, s.vals, _x(b),
                                               w=s.w))[:b, :256]
            for b in BATCHES}


@pytest.mark.parametrize("batch", BATCHES)
def test_plain_matches_jax_kernel(jax_mxu, batch):
    a = _matrix()
    f = SellMatrix.from_dense(a, device="cpu")
    x = torch.from_numpy(_x(batch))
    y = sell_mxu_spmm_plain(f.idx, f.vals, x, n=256).numpy()
    np.testing.assert_allclose(y, jax_mxu[batch], rtol=0, atol=1e-4)
    np.testing.assert_allclose(y, reference.sgemm_cpu(x.numpy(), a), rtol=0,
                               atol=1e-5)
    # the wrapper's CPU branch is the plain version
    np.testing.assert_array_equal(
        sell_mxu_spmm(f.idx, f.vals, x, n=256).numpy(), y)


def test_scatter_must_add():
    """Pad slots alias offset 0: an overwriting scatter loses the real
    offset-0 entries, the additive one keeps them."""
    a = _matrix()
    f = SellMatrix.from_dense(a, device="cpu")
    assert bool((f.idx[:, 0, 1:] == 0).any())      # pads exist in window 0
    x = torch.from_numpy(_x(3))
    nb, nt, w, _ = f.vals.shape
    lane = torch.arange(128)
    flat = (f.idx.long() * 128 + lane).reshape(nb, nt, w * 128)
    stored = torch.zeros((nb, nt, 128 * 128)).scatter_(
        2, flat, f.vals.reshape(nb, nt, w * 128))
    y_store = torch.einsum("btc,jtcr->bjr", x.reshape(3, nt, 128),
                           stored.view(nb, nt, 128, 128)).reshape(3, -1)
    want = reference.sgemm_cpu(x.numpy(), a)
    assert np.abs(y_store.numpy() - want).max() > 1e-2
    y = sell_mxu_spmm_plain(f.idx, f.vals, x, n=256).numpy()
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5)


def test_unaligned_shapes_and_short_x():
    """m and n off the 128 grid; x as narrow as m (the missing packed rows
    read as zero)."""
    a = jgen.random_sparse_matrix(200, 300, density=0.3, seed=5)
    f = SellMatrix.from_dense(a, device="cpu")
    x = jgen.random_sparse_batch(5, 200, 0.5, seed=5)
    y = sell_mxu_spmm_plain(f.idx, f.vals, torch.from_numpy(x), n=300)
    assert y.shape == (5, 300)
    np.testing.assert_allclose(y.numpy(), reference.sgemm_cpu(x, a), rtol=0,
                               atol=1e-5)
