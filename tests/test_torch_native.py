"""The port's native converters (``tpusparse_torch.native``): each packer's
native path against its numpy path and against the JAX package's native
library, bit for bit, on the cases of ``tests/test_native.py``; and
``use_native=True`` raising when the library is unavailable."""

import numpy as np
import pytest
from scipy import sparse as ssp

from tpusparse import native as jnative
from tpusparse.amg import _aggregate as j_aggregate
from tpusparse.formats.rsell import rsell_pack_csr as j_rsell_pack_csr
from tpusparse.formats.sell import sell_pack as j_sell_pack
from tpusparse.formats.sell import sell_pack_csr as j_sell_pack_csr
from tpusparse.testing import generators as jgen

from tpusparse_torch import native
from tpusparse_torch.amg import _aggregate
from tpusparse_torch.formats.bell import _mask_to_words, bell_pack
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.rsell import rsell_pack_csr
from tpusparse_torch.formats.sell import sell_pack, sell_pack_csr


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.fail(f"native build failed: {native.build_error()}")
    assert jnative.available()


@pytest.fixture(scope="module")
def dense():
    return jgen.random_sparse_matrix(512, 384, density=0.35, seed=41)


def _eq(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert x.tobytes() == y.tobytes()


def test_sell_pack(built, dense):
    nat = sell_pack(dense, use_native=True)
    ref = sell_pack(dense, use_native=False)
    jax = j_sell_pack(dense, use_native=True)
    assert nat["w"] == ref["w"] == jax["w"] and nat["nnz"] == ref["nnz"]
    for k in ("vals", "idx"):
        _eq(nat[k].numpy(), ref[k].numpy())
        _eq(nat[k].numpy(), jax[k])


def test_csr_from_dense(built, dense):
    nat = CsrMatrix.from_dense(dense, use_native=True)
    ref = CsrMatrix.from_dense(dense, use_native=False)
    jax = jnative.csr_from_dense(dense)
    for k, j in zip(("row_ptr", "col_idx", "values"), jax):
        _eq(getattr(nat, k), getattr(ref, k))
        _eq(getattr(nat, k), j)


@pytest.mark.parametrize("block_m", [128, 256])
def test_bell_bitmap(built, dense, block_m):
    nb = dense.shape[1] // 128
    t = dense.reshape(dense.shape[0] // block_m, block_m, nb, 128) \
        .transpose(2, 0, 3, 1)
    nat = native.bell_bitmap(dense, block_m)
    _eq(nat, _mask_to_words(t != 0, block_m))
    _eq(nat, jnative.bell_bitmap(dense, block_m))
    _eq(bell_pack(dense, block_m=block_m)["bitmap"], nat)


def test_sell_fill_csr(built):
    a = jgen.random_sparse_matrix(640, 384, density=0.25, seed=61,
                                  distribution="powerlaw")
    csr = CsrMatrix.from_dense(a)
    nat = sell_pack_csr(csr, use_native=True)
    ref = sell_pack_csr(csr, use_native=False)
    jax = j_sell_pack_csr(csr, use_native=True)
    assert nat["w"] == ref["w"] == jax["w"]
    for k in ("vals", "idx"):
        _eq(nat[k].numpy(), ref[k].numpy())
        _eq(nat[k].numpy(), jax[k])


@pytest.mark.parametrize("dist", ["uniform", "powerlaw", "blocks"])
@pytest.mark.parametrize("sort", [False, "auto"])
def test_rsell_pack(built, dist, sort):
    a = jgen.random_sparse_matrix(640, 512, density=0.2, seed=43,
                                  distribution=dist)
    c = CsrMatrix.from_dense(a)
    nat = rsell_pack_csr(c, sort=sort, use_native=True)
    ref = rsell_pack_csr(c, sort=sort, use_native=False)
    jax = j_rsell_pack_csr(c, sort=sort, use_native=True)
    for k in ("n_real", "w_max", "run", "nnz"):
        assert nat[k] == ref[k] == jax[k], k
    for k in ("cj", "ct", "vals", "idx"):
        _eq(nat[k], ref[k])
        _eq(nat[k], jax[k])


@pytest.mark.parametrize("theta", [0.0, 0.1])
@pytest.mark.parametrize("seed", [1, 2])
def test_amg_aggregate(built, theta, seed):
    a = jgen.random_sparse_matrix(300, 300, density=0.03, seed=seed)
    a = a + a.T + 10.0 * np.eye(300, dtype=np.float32)
    sp = ssp.csr_matrix(a.astype(np.float64))
    agg_n, cnt_n = _aggregate(sp, theta, use_native=False)
    agg_c, cnt_c = _aggregate(sp, theta, use_native=True)
    agg_j, cnt_j = j_aggregate(sp, theta, use_native=True)
    assert cnt_n == cnt_c == cnt_j
    _eq(agg_c, agg_n)
    _eq(agg_c, agg_j)


def test_use_native_true_raises_when_unavailable(monkeypatch, dense):
    monkeypatch.setattr(native, "_lib", lambda: None)
    assert not native.available()
    csr = CsrMatrix.from_dense(dense, use_native=False)
    sp = ssp.csr_matrix(np.eye(4))
    for call in (lambda: CsrMatrix.from_dense(dense, use_native=True),
                 lambda: sell_pack(dense, use_native=True),
                 lambda: sell_pack_csr(csr, use_native=True),
                 lambda: rsell_pack_csr(csr, use_native=True),
                 lambda: _aggregate(sp, 0.0, use_native=True)):
        with pytest.raises(RuntimeError, match="native"):
            call()
    # None takes the numpy path, with the same bits
    ref = sell_pack(dense, use_native=False)
    got = sell_pack(dense)
    _eq(got["vals"].numpy(), ref["vals"].numpy())
    assert native.bell_bitmap(dense, 128) is None


def test_build_is_keyed_and_atomic(built):
    so = native._build()
    assert so.parent == native.BUILD_DIR and so.suffix == ".so"
    assert so.name.startswith("converters_") and so.exists()
