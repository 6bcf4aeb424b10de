"""ASP (dense A with a window-skip plan) in the port against the JAX package:
``a_pad`` and the host plans bit-identical; the plain K9 with a host plan
and with a device plan within 1e-4 of the JAX package's Pallas kernel in
interpret mode (``_asp_call`` and ``_asp_call_dynamic``) and within 1e-3 of
the float64 oracle; an all-zero X gives y = 0.
"""

import numpy as np
import pytest
import torch

from tpusparse.kernels.asp_spmv import AspMatrix as JAsp
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch.formats import AspMatrix, CsrMatrix
from tpusparse_torch.kernels.asp_spmv import asp_spmm, asp_spmm_plain
from tpusparse_torch.kernels.awsp_spmv import device_group_plan

ATOL_JAX = 1e-4
ATOL_ORACLE = 1e-3


def _x(m, batch, seed, live=None):
    x = jgen.random_sparse_vector(m, 0.5, seed=seed) if batch == 1 \
        else jgen.random_sparse_batch(batch, m, 0.5, seed=seed)
    if live is not None:                 # only rows in `live` nonzero
        x = np.where(live(np.arange(m)), x + 1e-3 * (x == 0), 0)
    return x.astype(np.float32)


def _oracle(x, a):
    return reference.sgemv_cpu(x, a) if x.ndim == 1 else reference.sgemm_cpu(x, a)


def _close(got, jy, y_ref):
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, np.asarray(jy, np.float64), rtol=0,
                               atol=ATOL_JAX)
    np.testing.assert_allclose(got, y_ref, rtol=0, atol=ATOL_ORACLE)


@pytest.mark.parametrize("block_n", [2048, 128, 512])
@pytest.mark.parametrize("shape", [(256, 384), (200, 300), (130, 1)])
def test_a_pad_and_plans_match_jax(shape, block_n):
    a = jgen.random_sparse_matrix(*shape, density=0.5, seed=41)
    j = JAsp.from_dense(a, block_n=block_n)
    t = AspMatrix.from_dense(a, block_n=block_n, device="cpu")
    assert np.array_equal(t.a_pad.numpy(), np.asarray(j.a_pad))
    assert t.a_pad.dtype == torch.float32
    assert (t.shape, t.block_n) == (tuple(j.shape), j.block_n)
    assert t.device_bytes() == j.device_bytes()
    assert np.array_equal(t.to_dense().numpy(), a)
    assert np.array_equal(t._full_plan().numpy(), j._full_plan())
    m = shape[0]
    for live in (None, lambda r: r < 128, lambda r: r >= 128,
                 lambda r: r < 0):
        for batch in (1, 3):
            x = _x(m, batch, 42, live)
            p = t.plan(x)
            assert p.dtype == np.int32
            assert np.array_equal(p, j.plan(x))
            assert np.array_equal(t.plan(torch.from_numpy(x)), p)
    assert "AspMatrix" in repr(t)


def test_from_csr_matches_from_dense():
    a = jgen.random_sparse_matrix(300, 200, density=0.7, seed=43)
    t = AspMatrix.from_csr(CsrMatrix.from_dense(a), device="cpu")
    assert np.array_equal(t.a_pad.numpy(),
                          np.asarray(JAsp.from_dense(a).a_pad))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("live", ["all", "head", "tail"])
def test_plain_host_plan_matches_jax(batch, live):
    a = jgen.random_sparse_matrix(512, 384, density=0.5, seed=44)
    sel = {"all": None, "head": lambda r: r < 128,
           "tail": lambda r: r >= 256}[live]
    x = _x(512, batch, 45, sel)
    j = JAsp.from_dense(a)
    t = AspMatrix.from_dense(a, device="cpu")
    jy = j.spmv(x) if batch == 1 else j.spmm(x)
    ty = t.spmv(x) if batch == 1 else t.spmm(x)
    assert ty.shape == tuple(jy.shape)
    _close(ty, jy, _oracle(x, a))
    full = t._full_plan()
    ty = t.spmv(x, plan=full) if batch == 1 else t.spmm(x, plan=full)
    _close(ty, jy, _oracle(x, a))


@pytest.mark.parametrize("batch", [1, 2])
def test_plain_device_plan_matches_jax_dynamic(batch):
    a = jgen.random_sparse_matrix(384, 300, density=0.5, seed=46)
    j = JAsp.from_dense(a)
    t = AspMatrix.from_dense(a, device="cpu")
    for sel in (lambda r: (r // 128) % 2 == 1, None):
        x = _x(384, batch, 47, sel)
        jy = j.spmv(x, plan="device") if batch == 1 \
            else j.spmm(x, plan="device")
        ty = t.spmv(x, plan="device") if batch == 1 \
            else t.spmm(x, plan="device")
        _close(ty, jy, _oracle(x, a))
    z = np.zeros_like(x)
    ty = t.spmv(z, plan="device") if batch == 1 else t.spmm(z, plan="device")
    assert torch.count_nonzero(ty) == 0
    np.testing.assert_array_equal(
        np.asarray(j.spmv(z, plan="device") if batch == 1
                   else j.spmm(z, plan="device")), 0.0)


def test_plain_direct_calls_and_zero_window():
    a = jgen.random_sparse_matrix(300, 200, density=0.5, seed=48)
    t = AspMatrix.from_dense(a, block_n=128, device="cpu")
    x = _x(300, 2, 49, lambda r: r >= 128)
    xt = torch.from_numpy(x)
    plan, k = device_group_plan(xt, t.n_units, 128)
    assert int(k[0]) == 2 and plan[:2].tolist() == [1, 2]
    y = asp_spmm_plain(plan, k, t.a_pad, xt, n=200)   # x narrower than rows
    assert torch.equal(asp_spmm(plan, k, t.a_pad, xt, n=200), y)
    np.testing.assert_allclose(y.numpy(), reference.sgemm_cpu(x, a), rtol=0,
                               atol=ATOL_ORACLE)
    zero = torch.zeros((1, 300))
    plan, k = device_group_plan(zero, t.n_units, 128)
    assert int(k[0]) == 1 and int(plan[0]) == t.n_units
    assert torch.count_nonzero(asp_spmm_plain(plan, k, t.a_pad, zero,
                                              n=200)) == 0
    host = torch.from_numpy(t.plan(np.zeros(300, np.float32)))
    assert host.tolist() == [t.n_units]
    with pytest.raises(ValueError, match="ids"):
        t.spmv(x[0], plan=np.array([t.n_units + 1]))
    with pytest.raises(ValueError, match="device"):
        t.spmv(x[0], plan="host")
