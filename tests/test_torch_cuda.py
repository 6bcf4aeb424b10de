"""Each CUDA kernel of the port against its plain PyTorch version on the
card, at a small size and at full size: the 4096 x 4096, d = 0.5 workload
for K1-K3, the 8192 x 8192 powerlaw d = 0.15 workload for K4, K5 and K9.

Marked ``gpu``: here, with no card, every test skips (decided in a fixture,
never at import). On the card, whose machine has no JAX, run:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

This file imports no JAX and nothing from tests/conftest.py.

Tolerance: 1e-4 between kernel and plain version (same products, summed in
another order), 1e-3 against the float64 oracle (the repo's contract).
"""

import functools

import numpy as np
import pytest
import torch

from tpusparse_torch.formats import (AspMatrix, AwspMatrix, RsellMatrix,
                                     SellMatrix)
from tpusparse_torch.kernels.asp_spmv import asp_spmm, asp_spmm_plain
from tpusparse_torch.kernels.awsp_spmv import (awsp_spmm, awsp_spmm_plain,
                                               device_group_plan)
from tpusparse_torch.kernels.dense import dense_cuda, dense_plain
from tpusparse_torch.kernels.permute import (permute_columns,
                                             permute_columns_plain)
from tpusparse_torch.kernels.rsell_spmv import rsell_spmm, rsell_spmm_plain
from tpusparse_torch.kernels.sell_spmv import sell_spmm, sell_spmm_plain
from tpusparse_torch.testing import generators, reference

pytestmark = pytest.mark.gpu

SIZES = {"small": (256, 384), "unaligned": (200, 300), "odd": (130, 301),
         "full": (4096, 4096)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _workload(size, batch, seed=0):
    m, n = SIZES[size]
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=seed)
    x = generators.random_sparse_batch(batch, m, 0.5, seed=seed)
    return a, x, reference.sgemm_cpu(x, a)


def _close(got, want, atol):
    err = (got.double().cpu() - torch.as_tensor(want).double().cpu()).abs()
    assert float(err.max()) <= atol, float(err.max())


def _padded(x, cols, dev):
    xp = torch.zeros((x.shape[0], cols), dtype=torch.float32, device=dev)
    xp[:, :x.shape[1]] = torch.from_numpy(x).to(dev)
    return xp


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("size", list(SIZES))
def test_sell_kernel(cuda, size, batch):
    a, x, y_ref = _workload(size, batch)
    f = SellMatrix.from_dense(a, device=cuda)
    xt = torch.from_numpy(x).to(cuda)
    y = sell_spmm(f.idx, f.vals, xt, n=f.shape[1])   # x narrower than rows
    torch.cuda.synchronize()
    _close(y, sell_spmm_plain(f.idx, f.vals, xt, n=f.shape[1]), 1e-4)
    _close(y, y_ref, 1e-3)
    xp = _padded(x, f.padded[0], cuda)                # x padded to the rows
    _close(sell_spmm(f.idx, f.vals, xp, n=f.shape[1]), y, 1e-4)


@pytest.mark.parametrize("lane", ["bfloat16", "int8"])
def test_sell_kernel_storage_lanes(cuda, lane):
    a, x, _ = _workload("small", 3)
    f = SellMatrix.from_dense(a, dtype=torch.bfloat16 if lane == "bfloat16"
                              else "int8", device=cuda)
    xp = _padded(x, f.padded[0], cuda)
    y = sell_spmm(f.idx, f.vals, xp, scales=f.scales, n=f.shape[1])
    _close(y, sell_spmm_plain(f.idx, f.vals, xp, scales=f.scales,
                              n=f.shape[1]), 1e-4)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("size", list(SIZES))
def test_dense_kernel(cuda, size, batch):
    a, x, y_ref = _workload(size, batch)
    at, xt = torch.from_numpy(a).to(cuda), torch.from_numpy(x).to(cuda)
    y = dense_cuda(at, xt)
    torch.cuda.synchronize()
    _close(y, dense_plain(at, xt), 1e-4)
    _close(y, y_ref, 1e-3)
    _close(dense_cuda(at, xt[0]), y_ref[0], 1e-3)


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("size", ["small", "full"])
def test_awsp_kernel_static_and_device_plan(cuda, size, g):
    a, x, _ = _workload(size, 3)
    m = a.shape[0]
    x[:, m // 4:] = 0.0                   # a quarter of the rows live
    y_ref = reference.sgemm_cpu(x, a)
    f = AwspMatrix.from_dense(a, g=g, device=cuda)
    xp = _padded(x, f.vals.shape[1] * 128, cuda)
    plan = torch.from_numpy(f.plan(x)).to(cuda)
    k = torch.full((1,), plan.numel(), dtype=torch.int32, device=cuda)
    y = awsp_spmm(plan, k, f.idx, f.vals, xp, g=g, n=f.shape[1])
    _close(y, awsp_spmm_plain(plan, k, f.idx, f.vals, xp, g=g,
                              n=f.shape[1]), 1e-4)
    _close(y, y_ref, 1e-3)
    dplan, dk = device_group_plan(xp, f.n_groups, g * 128)
    yd = awsp_spmm(dplan, dk, f.idx, f.vals, xp, g=g, n=f.shape[1])
    _close(yd, y, 1e-4)
    _close(yd, y_ref, 1e-3)


def test_awsp_device_plan_has_no_host_sync(cuda):
    a, x, _ = _workload("small", 2)
    x[:, 128:] = 0.0
    f = AwspMatrix.from_dense(a, g=1, device=cuda)
    xt = torch.from_numpy(x).to(cuda)
    zero = torch.zeros_like(xt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = f.spmm(xt)                    # CUDA tensor -> device plan
        y0 = f.spmm(zero)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _close(y, reference.sgemm_cpu(x, a), 1e-3)
    assert int(torch.count_nonzero(y0)) == 0


# RSELL packs: (m, n, density, distribution, seed, sorted, run)
RSELL = {"run": (512, 640, 0.2, "powerlaw", 1, True, 8),
         "flat": (256, 2048, 0.01, "uniform", 6, True, 1),
         "unsorted": (384, 256, 0.3, "uniform", 17, False, 8),
         "full": (8192, 8192, 0.15, "powerlaw", 0, True, 8)}


@functools.cache
def _skewed(name):
    m, n, d, dist, seed = RSELL[name][:5]
    return generators.random_sparse_matrix(m, n, density=d, seed=seed,
                                           distribution=dist)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("name", list(RSELL))
def test_rsell_kernel(cuda, name, batch):
    a = _skewed(name)
    x = generators.random_sparse_batch(batch, a.shape[0], 0.5, seed=1)
    f = RsellMatrix.from_dense(a, device=cuda)
    assert (f.perm_src is not None, f.run) == RSELL[name][5:]
    xt = torch.from_numpy(x).to(cuda)
    args = (f.cj, f.ct, f.idx, f.vals, xt)
    y = rsell_spmm(*args, n_padded=f.padded[1], plan=f._work)
    torch.cuda.synchronize()
    _close(y, rsell_spmm_plain(*args, n_padded=f.padded[1]), 1e-4)
    _close(rsell_spmm(*args, n_padded=f.padded[1]), y, 0.0)  # own plan
    _close(f.spmm(xt), reference.sgemm_cpu(x, a), 1e-3)       # K4 (+ K5)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("n,src_size", [(8192, None), (640, None),
                                        (200, 300)])
def test_permute_kernel(cuda, n, src_size, batch):
    rng = np.random.default_rng(n)
    src = rng.permutation(src_size or n)[:n].astype(np.int32)
    src[::7] = -1                                     # dead lanes read 0
    y = torch.from_numpy(rng.uniform(-1, 1, (batch, src_size or n))
                         .astype(np.float32)).to(cuda)
    st = torch.from_numpy(src).to(cuda)
    out = permute_columns(y, st)
    torch.cuda.synchronize()
    assert torch.equal(out, permute_columns_plain(y, st))
    want = np.where(src >= 0, y.cpu().numpy()[:, np.maximum(src, 0)], 0)
    assert np.array_equal(out.cpu().numpy(), want)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("size", ["small", "unaligned", "full"])
def test_asp_kernel_static_and_device_plan(cuda, size, batch):
    if size == "full":
        a = _skewed("full")
        x = generators.random_sparse_batch(batch, 8192, 0.5, seed=2)
    else:
        a, x, _ = _workload(size, batch)
    m = a.shape[0]
    f = AspMatrix.from_dense(a, device=cuda)
    for live in (np.arange(m) < m, (np.arange(m) // 128) % 4 == 1):
        xs = np.where(live, x, 0).astype(np.float32)
        y_ref = reference.sgemm_cpu(xs, a)
        xt = torch.from_numpy(xs).to(cuda)
        plan = torch.from_numpy(f.plan(xs)).to(cuda)
        k = torch.full((1,), plan.numel(), dtype=torch.int32, device=cuda)
        y = asp_spmm(plan, k, f.a_pad, xt, n=f.shape[1])
        torch.cuda.synchronize()
        _close(y, asp_spmm_plain(plan, k, f.a_pad, xt, n=f.shape[1]), 1e-4)
        _close(y, y_ref, 1e-3)
        yd = f.spmm(xt)                   # CUDA tensor -> device plan
        _close(yd, y, 1e-4)
        _close(f.spmm(xs), y, 0.0)        # host data -> the same host plan


def test_skew_device_paths_have_no_host_sync(cuda):
    a = _skewed("run")
    x = generators.random_sparse_batch(2, 512, 0.5, seed=3)
    x[:, 128:384] = 0.0
    r = RsellMatrix.from_dense(a, device=cuda)
    asp = AspMatrix.from_dense(a, device=cuda)
    xt = torch.from_numpy(x).to(cuda)
    zero = torch.zeros_like(xt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yr, ya, y0 = r.spmm(xt), asp.spmm(xt), asp.spmm(zero)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _close(yr, reference.sgemm_cpu(x, a), 1e-3)
    _close(ya, reference.sgemm_cpu(x, a), 1e-3)
    assert int(torch.count_nonzero(y0)) == 0


def test_public_path_launches_the_kernels(cuda):
    import tpusparse_torch

    a, x, _ = _workload("small", 2)
    wrappers = (sell_spmm, awsp_spmm, dense_cuda, rsell_spmm,
                permute_columns, asp_spmm)
    before = [w.launches for w in wrappers]
    SellMatrix.from_dense(a, device=cuda).spmm(x)
    AwspMatrix.from_dense(a, device=cuda).spmm(x)
    dense_cuda(torch.from_numpy(a).to(cuda), torch.from_numpy(x).to(cuda))
    skew = _skewed("run")
    xs = generators.random_sparse_vector(512, 0.5, seed=4)
    r = tpusparse_torch.auto_format(skew, expect_batch=1)
    assert isinstance(r, RsellMatrix) and r.perm_src is not None
    tpusparse_torch.spmv(r, xs)
    f = tpusparse_torch.auto_format(skew, expect_batch=8)
    assert isinstance(f, AspMatrix)
    tpusparse_torch.spmm(f, np.stack([xs] * 8))
    after = [w.launches for w in wrappers]
    assert all(u == v + 1 for u, v in zip(after, before))
