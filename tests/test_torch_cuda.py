"""Each CUDA kernel of the port against its plain PyTorch version on the
card, at a small size and at full size: the 4096 x 4096, d = 0.5 workload
for K1-K3, K10, K11 and K12, the 8192 x 8192 powerlaw d = 0.15 workload
for K4, K5, K9 and binned SELL, blockpruned-4096 for K6 and K7, the 1024^2
5-point Laplacian for K8; the training path's launches and its backward
without a host sync; and the full registry's public paths.

Marked ``gpu``: here, with no card, every test skips (decided in a fixture,
never at import). On the card, whose machine has no JAX, run:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

This file imports no JAX and nothing from tests/conftest.py.

Tolerance: 1e-4 between kernel and plain version (same products, summed in
another order), 1e-3 against the float64 oracle (the repo's contract).

K2, K11 and K12 sum their split contraction inside the one kernel: their
tests (which also run K6 and K7) check that two calls give the same bits,
that calls on two streams and calls after calls of another shape still
match, that a call is one CUDA kernel, and (with ``cuobjdump``) that K11
multiplies in 3xTF32 on the tensor cores, K2, K12 and K6's ring copy
asynchronously and K1's ring kernel bulk-copies its tiles. K1 (every batch size from 1 to 40, its storage lanes, x narrower
than the rows, one window, W = 8), K12 (every block_m it takes, W up to
1024, empty and full columns), K6 (block_m 8-512) and K7 (W 1-128, both
at B in {1, 2, 3, 5, 8, 9, 16}, empty packs) are also held to the same
bits on two calls; K4 keeps its bits after K6 and K7 calls. K3 (one
kernel a call, its live rows split on the device, summed like K2) is held
at the live fractions 0, 1/16, 1/4 and 1, with fp32 and bf16 values, to
the same bits on two calls, and its device plan's kernel to the plain
plan bit for bit; a sorted RSELL pack's call is K4 alone, its unpermute in
the second kernel, the same bits as K4 then K5; a binned call is K1 a
bucket and one K5, with no ``torch.cat``. K9 (one
kernel a call, summed across its cluster in distributed shared memory) is
held at every cluster size, with lda % 4 != 0 and A off 16-byte
alignment, through static, device and explicit plans; K4 (two kernels a
call) with x off 4 columns and off 16-byte alignment; both to the same
bits on two calls. K8 (one kernel a ``DiaMatrix.spmv`` call, its windows
staged from the matrix's plan) gives its plain version's bits on every
banded shape, with n % 4 != 0, a strided vals view, an offset past any
tile, 32 diagonals, negative offsets only and n = 1024, at every tile and
with windows left in global memory; and with halo strips (random, and the
wrap strips of a one-rank ring, which must add exactly 0), in both bodies.
"""

import functools
import re

import numpy as np
import pytest
import torch

from tpusparse_torch.autodiff import _TwinPack, trainable_linear
from tpusparse_torch.bench.suite import registry
from tpusparse_torch.formats import (AspMatrix, AwspMatrix, BellMatrix,
                                     BinnedSellMatrix, BsrMatrix, CsrMatrix,
                                     DiaMatrix, RsellMatrix, SellMatrix,
                                     TcsrMatrix)
from tpusparse_torch.formats import tcsr as tcsr_mod
from tpusparse_torch.formats.bell import _mask_to_words
from tpusparse_torch.kernels.asp_spmv import asp_spmm, asp_spmm_plain
from tpusparse_torch.kernels.awsp_spmv import (awsp_spmm, awsp_spmm_plain,
                                               device_group_plan,
                                               device_group_plan_plain)
from tpusparse_torch.kernels.bell_spmv import bell_spmm, bell_spmm_plain
from tpusparse_torch.kernels.bsell_spmv import (bsell_plans, bsell_spmm,
                                               bsell_spmm_plain)
from tpusparse_torch.kernels.bsr_spmv import bsr_spmm, bsr_spmm_plain
from tpusparse_torch.kernels.dia_spmv import dia_spmv, dia_spmv_plain, fits
from tpusparse_torch.kernels.dense import dense_cuda, dense_plain
from tpusparse_torch.kernels.permute import (permute_columns,
                                             permute_columns_plain)
from tpusparse_torch.kernels.rsell_spmv import (rsell_spmm, rsell_spmm_plain,
                                                unpermute_lanes)
from tpusparse_torch.kernels.sell_grad import sell_dvals, sell_dvals_plain
from tpusparse_torch.kernels.sell_mxu_spmm import (sell_mxu_spmm,
                                                   sell_mxu_spmm_plain)
from tpusparse_torch.kernels.sell_spmv import sell_spmm, sell_spmm_plain
from tpusparse_torch.nn import SparseLinear
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


# K1 shapes: (m, n, density). "unaligned": n off the 128 grid and x
# narrower than the packed rows; "nt1": one window; "tinyw": W = 8.
K1_CASES = {"full": (4096, 4096, 0.5), "small": (256, 384, 0.5),
            "unaligned": (200, 300, 0.5), "nt1": (100, 300, 0.5),
            "tinyw": (256, 384, 0.01)}


def _twice(call):
    """Two calls of a kernel: its output, after checking both give the same
    bits."""
    y = call()
    y2 = call()
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    return y


@pytest.mark.parametrize("batch", [1, 2, 3, 8, 9, 32, 40])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_sell_kernel_whole_batch(cuda, case, batch):
    """K1 reads the pack once for up to 32 batch rows (B = 40: two blocks
    down the batch), at every edge of its layout; deterministic."""
    m, n, d = K1_CASES[case]
    a = generators.random_sparse_matrix(m, n, density=d, seed=batch)
    x = generators.random_sparse_batch(batch, m, 0.5, seed=batch)
    f = SellMatrix.from_dense(a, device=cuda)
    if case == "tinyw":
        assert f.w == 8
    if case == "nt1":
        assert f.idx.shape[1] == 1
    xt = torch.from_numpy(x).to(cuda)
    y = _twice(lambda: sell_spmm(f.idx, f.vals, xt, n=n))
    _close(y, sell_spmm_plain(f.idx, f.vals, xt, n=n), 1e-4)
    _close(y, reference.sgemm_cpu(x, a), 1e-3)


@pytest.mark.parametrize("batch", [1, 9, 32])
@pytest.mark.parametrize("lane", ["bfloat16", "int8"])
def test_sell_kernel_storage_lanes_whole_batch(cuda, lane, batch):
    """The bf16 and int8 lanes (int8 scales applied after the fused sum),
    against the plain version and the float64 product of the stored A."""
    a = generators.random_sparse_matrix(300, 260, density=0.5, seed=batch)
    f = SellMatrix.from_dense(a, dtype=torch.bfloat16 if lane == "bfloat16"
                              else "int8", device=cuda)
    x = generators.random_sparse_batch(batch, 300, 0.5, seed=batch)
    xt = torch.from_numpy(x).to(cuda)
    y = _twice(lambda: sell_spmm(f.idx, f.vals, xt, scales=f.scales, n=260))
    _close(y, sell_spmm_plain(f.idx, f.vals, xt, scales=f.scales, n=260),
           1e-4)
    _close(y, reference.sgemm_cpu(x, f.to_dense().float().numpy()), 1e-3)


def _k1_unplanned(f, xt):
    """K1 through its 19-argument C entry, as every call made it before
    launch plans: its own partial sums, the current stream's handle."""
    from tpusparse_torch.kernels import _build
    from tpusparse_torch.kernels.sell_spmv import _VALS_KIND, sell_shape

    nb, nt, w, _ = f.vals.shape
    batch, dev = xt.shape[0], xt.device
    shape = sell_shape(nb, nt, w, batch, f.vals.element_size(),
                       _build.sm_count(dev), _build.smem_limit(dev))
    part = torch.empty((shape.slices, batch, nb * 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, f.shape[1]), dtype=torch.float32, device=dev)
    _build.check(_build.lib().tps_sell_spmm(
        f.idx.data_ptr(), f.vals.data_ptr(), _VALS_KIND[f.vals.dtype],
        xt.data_ptr(), None if f.scales is None else f.scales.data_ptr(),
        part.data_ptr(), y.data_ptr(), nb, nt, w, batch, xt.shape[1],
        shape.slices, shape.per_slice, f.shape[1], shape.bb, shape.stages,
        dev.index, _build.stream_of(xt)), "tps_sell_spmm")
    return y


@pytest.mark.parametrize("batch", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("lane", ["float32", "bfloat16", "int8"])
def test_sell_plan_matches_the_checked_call(cuda, lane, batch):
    """A ``SellMatrix`` product through its reused plan gives the bits of
    the checked ``sell_spmm`` and of the C entry called as before plans;
    ``spmv`` gives a vector of those bits."""
    from tpusparse_torch.kernels.sell_spmv import sell_plan

    a = generators.random_sparse_matrix(4096, 4096, density=0.5, seed=batch)
    f = SellMatrix.from_dense(a, dtype=None if lane == "float32" else
                              torch.bfloat16 if lane == "bfloat16" else
                              "int8", device=cuda)
    x = generators.random_sparse_batch(batch, 4096, 0.5, seed=batch)
    xt = torch.from_numpy(x).to(cuda)
    f.spmm(xt)                                      # builds the plan
    hits = sell_plan.hits
    y = f.spmm(xt)
    assert sell_plan.hits == hits + 1
    checked = sell_spmm(f.idx, f.vals, xt, scales=f.scales, n=f.shape[1])
    torch.cuda.synchronize()
    assert torch.equal(y, checked)
    assert torch.equal(y, _k1_unplanned(f, xt))
    if batch == 1:
        v = f.spmv(xt[0])
        v2 = f.spmv(xt[0])
        torch.cuda.synchronize()
        assert v.shape == (f.shape[1],) and torch.equal(v, y[0])
        assert torch.equal(v2, y[0])
    _close(y, sell_spmm_plain(f.idx, f.vals, xt, scales=f.scales,
                              n=f.shape[1]), 1e-4)


def _stack(cuda):
    """Four packs of three shapes and 16 products over them, each with its
    own x."""
    shapes = [(4096, 4096), (1024, 2048), (4096, 4096), (300, 260)]
    packs = [SellMatrix.from_dense(generators.random_sparse_matrix(
        m, n, density=0.5, seed=k), device=cuda)
        for k, (m, n) in enumerate(shapes)]
    work = []
    for k in range(16):
        f = packs[k % 4]
        x = torch.from_numpy(generators.random_sparse_vector(
            f.shape[0], 0.5, seed=100 + k)).to(cuda)
        work.append((f, x))
    return work


def test_sell_plans_back_to_back_on_one_stream(cuda):
    """16 products on one stream, dispatched with no sync between them,
    each with partial sums the caching allocator hands on in stream order,
    each gives the bits of its own product run alone."""
    work = _stack(cuda)
    alone = []
    for f, x in work:
        alone.append(f.spmv(x))
        torch.cuda.synchronize()
    for rep in range(3):
        ys = [f.spmv(x) for f, x in work]
        torch.cuda.synchronize()
        for k, (y, want) in enumerate(zip(ys, alone)):
            assert torch.equal(y, want), (rep, k)
    assert all(len(f._plans) == 1 for f, _ in work)


def test_sell_plans_on_two_streams(cuda):
    """The same packs on two streams: a plan each, and products in flight
    on both at once give the bits of each alone."""
    from tpusparse_torch.kernels import _build

    work = _stack(cuda)
    alone = [f.spmv(x) for f, x in work]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for rep in range(3):
        for k, (f, x) in enumerate(work):
            with torch.cuda.stream(streams[(k + rep) % 2]):
                got.append((k, f.spmv(x)))
    torch.cuda.synchronize()
    for k, y in got:
        assert torch.equal(y, alone[k]), k
    f, x = work[0]
    keys = {key[3] for key in f._plans}
    assert {s.cuda_stream for s in streams} <= keys
    assert _build.raw_stream(x.device.index) == \
        torch.cuda.current_stream().cuda_stream
    with torch.cuda.stream(streams[1]):
        assert _build.raw_stream(x.device.index) == streams[1].cuda_stream


@pytest.mark.parametrize("batch", [1, 3, 8, 9, 32])
@pytest.mark.parametrize("block_m", [32, 128, 256, 512, 1024])
def test_bell_kernel_live_values(cuda, block_m, batch):
    """K12 at every block_m it takes, with an all-empty and an all-full
    column (so W is block_m rounded up to 128: 1024 at block_m 1024);
    deterministic."""
    a = generators.random_sparse_matrix(2048, 384, density=0.5, seed=block_m)
    a[:, 5] = 0.0
    a[:, 7] = np.random.default_rng(7).uniform(0.5, 1.0, 2048)
    bitmap, vals = _bell_arrays(a, block_m, cuda)
    assert vals.shape[-1] == block_m          # W: the full column's count
    x = generators.random_sparse_batch(batch, 2048, 0.5, seed=batch)
    xt = torch.from_numpy(x).to(cuda)
    y = _twice(lambda: bell_spmm(bitmap, vals, xt, block_m=block_m, n=384))
    _close(y, bell_spmm_plain(bitmap, vals, xt, block_m=block_m, n=384),
           1e-4)
    _close(y, reference.sgemm_cpu(x, a), 1e-3)


def _bell_arrays(a, block_m, dev):
    """K12's bitmap and values for A (m a multiple of block_m, n of 128) at
    any block_m (the BELL packer takes multiples of 128), W the largest
    count: the packer's layout."""
    m, n = a.shape
    t = a.reshape(m // block_m, block_m, n // 128, 128).transpose(2, 0, 3, 1)
    mask = t != 0
    w = int(mask.sum(axis=-1).max())
    vals = np.zeros(t.shape[:-1] + (w,), np.float32)
    jj, ii, rr, _ = np.nonzero(mask)
    vals[jj, ii, rr, (np.cumsum(mask, axis=-1) - mask)[mask]] = t[mask]
    words = _mask_to_words(mask, block_m).view(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(words)).to(dev),
            torch.from_numpy(vals).to(dev))


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


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("m,n,offset", [(300, 100, 0), (4099, 4096, 0),
                                        (1000, 520, 1), (37, 4096, 0)])
def test_dense_kernel_edges(cuda, m, n, offset, batch):
    """K2 at n < 128, at an m that does not divide into the slices or into
    16-row stages, with A one float off 16-byte alignment (the masked
    copies), and with fewer rows than one slice."""
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=7)
    x = generators.random_sparse_batch(batch, m, 0.5, seed=7)
    buf = torch.empty(m * n + offset, dtype=torch.float32, device=cuda)
    at = buf[offset:].view(m, n)
    at.copy_(torch.from_numpy(a))
    assert (at.data_ptr() % 16 == 0) == (offset == 0)
    xt = torch.from_numpy(x).to(cuda)
    y = dense_cuda(at, xt)
    torch.cuda.synchronize()
    _close(y, dense_plain(at, xt), 1e-4)
    _close(y, reference.sgemm_cpu(x, a), 1e-3)


def _fused_cases(dev):
    """K1, K2, K11, K12, K3, K6 and K7 at two shapes each (K6 and K7 sum their
    items in a second kernel, a different one at 8 batch rows and at 3):
    (name, call) pairs, the call returning the kernel's output and its
    plain version's."""
    cases = []
    for m, n, batch in ((4096, 4096, 8), (200, 300, 3)):
        a = generators.random_sparse_matrix(m, n, density=0.3, seed=m)
        x = generators.random_sparse_batch(batch, m, 0.5, seed=m)
        at, xt = torch.from_numpy(a).to(dev), torch.from_numpy(x).to(dev)
        f = SellMatrix.from_dense(a, device=dev)
        cases.append((f"dense {m}x{n}", lambda at=at, xt=xt: (
            dense_cuda(at, xt), dense_plain(at, xt))))
        cases.append((f"mxu {m}x{n}", lambda f=f, xt=xt, n=n: (
            sell_mxu_spmm(f.idx, f.vals, xt, n=n),
            sell_mxu_spmm_plain(f.idx, f.vals, xt, n=n))))
        cases.append((f"sell {m}x{n}", lambda f=f, xt=xt, n=n: (
            sell_spmm(f.idx, f.vals, xt, n=n),
            sell_spmm_plain(f.idx, f.vals, xt, n=n))))
        g = BellMatrix.from_dense(a, device=dev)
        cases.append((f"bell {m}x{n}", lambda g=g, xt=xt, n=n: (
            bell_spmm(g.bitmap, g.vals, xt, block_m=g.block_m, n=n),
            bell_spmm_plain(g.bitmap, g.vals, xt, block_m=g.block_m, n=n))))
        b = BsrMatrix.from_dense(a, block_m=128, device=dev)
        cases.append((f"bsr {m}x{n}", lambda b=b, xt=xt, n=n: (
            bsr_spmm(b.bi, b.bj, b.blocks, xt, n_padded=b.padded[1], n=n,
                     plan=b._work),
            bsr_spmm_plain(b.bi, b.bj, b.blocks, xt, n_padded=b.padded[1],
                           n=n))))
        w = AwspMatrix.from_dense(a, g=2, device=dev)
        wp, wk = w._full_plan(), w._count(w.n_groups)
        cases.append((f"awsp {m}x{n}", lambda w=w, wp=wp, wk=wk, xt=xt, n=n: (
            awsp_spmm(wp, wk, w.idx, w.vals, xt, g=2, n=n),
            awsp_spmm_plain(wp, wk, w.idx, w.vals, xt, g=2, n=n))))
        t = TcsrMatrix.from_dense(a, device=dev)
        assert t.vals.shape[0] > 0
        cases.append((f"bsell {m}x{n}", lambda t=t, xt=xt, n=n: (
            bsell_spmm(t.s_bi, t.s_bj, t.idx, t.vals, xt,
                       n_padded=t.padded[1], n=n, plan=t._work),
            bsell_spmm_plain(t.s_bi, t.s_bj, t.idx, t.vals, xt,
                             n_padded=t.padded[1], n=n))))
    return cases


def test_fused_reduce_is_deterministic_and_resets(cuda):
    """K2, K11, K12 and K3 sum their slices in the kernel (K1, K6 and K7 in
    a reduce pass):
    two calls back to back give the same bits, and a call after a call of
    another shape still matches (the arrival counters are back at 0)."""
    cases = _fused_cases(cuda)
    first = {}
    for name, call in cases + cases:         # each shape after the others
        y, yp = call()
        torch.cuda.synchronize()
        _close(y, yp, 1e-4)
        if name in first:
            assert torch.equal(y, first[name]), name
        first[name] = y
        y2, _ = call()
        assert torch.equal(y, y2), name


def test_fused_reduce_on_two_streams(cuda):
    """Calls in flight on two streams each count on their own counters."""
    cases = _fused_cases(cuda)
    want = {name: call() for name, call in cases}
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = {}
    for rep in range(3):
        for k, (name, call) in enumerate(cases):
            with torch.cuda.stream(streams[k % 2]):
                got[name, rep] = call()[0]
    torch.cuda.synchronize()
    for (name, rep), y in got.items():
        assert torch.equal(y, want[name][0]), (name, rep)


def test_one_kernel_per_call(cuda):
    """torch.profiler sees exactly one CUDA kernel per K2, K11, K12, K9 and
    K3 call (K9 sums its cluster's slices in the kernel, K3 its parts) and
    per ``DiaMatrix.spmv`` call (K8), one for the device plan, two per K4 call (its items, then the group sum)
    and two per sorted RSELL call (the sum writes the user's column order);
    the plain versions are not called here."""
    a, x, _ = _workload("full", 8)
    at, xt = torch.from_numpy(a).to(cuda), torch.from_numpy(x).to(cuda)
    f = SellMatrix.from_dense(a, device=cuda)
    g = BellMatrix.from_dense(a, device=cuda)
    h = AspMatrix.from_dense(a, device=cuda)
    r = RsellMatrix.from_dense(a, device=cuda)
    plan = h._full_plan()
    k = h._count(plan.numel())
    w = AwspMatrix.from_dense(a, g=8, device=cuda)
    wp, wk = w._full_plan(), w._count(w.n_groups)
    skew = _skewed("run")
    rs = RsellMatrix.from_dense(skew, device=cuda)
    xs = torch.from_numpy(generators.random_sparse_batch(8, 512, 0.5,
                                                          seed=1)).to(cuda)
    assert rs.unpermute is not None
    binned = BinnedSellMatrix.from_dense(skew, device=cuda)
    dd = DiaMatrix.from_csr(generators.stencil_csr((1024, 1024)), device=cuda)
    xd = torch.from_numpy(generators.random_sparse_vector(
        1 << 20, 0.5, seed=2)).to(cuda)
    calls = {"awsp": (1, lambda: awsp_spmm(wp, wk, w.idx, w.vals, xt, g=8,
                                           n=4096)),
             # K1 (and its reduce) a bucket, then K5: no copy between
             "binned": (2 * len(binned.widths) + 1, lambda: binned.spmm(xs)),
             "plan": (1, lambda: device_group_plan(xt, w.n_groups, w.span)),
             "sorted rsell": (2, lambda: rs.spmm(xs)),
             "dense": (1, lambda: dense_cuda(at, xt)),
             "mxu": (1, lambda: sell_mxu_spmm(f.idx, f.vals, xt, n=4096)),
             "bell": (1, lambda: bell_spmm(g.bitmap, g.vals, xt,
                                           block_m=g.block_m, n=4096)),
             "asp": (1, lambda: asp_spmm(plan, k, h.a_pad, xt, n=4096)),
             "rsell": (2, lambda: rsell_spmm(r.cj, r.ct, r.idx, r.vals, xt,
                                             n_padded=4096, plan=r._work)),
             "dia": (1, lambda: dd.spmv(xd))}
    for name, (per_call, call) in calls.items():
        call()                               # counters allocated, warm
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 3 * per_call, (name, [e.name for e in kernels])


def test_traced_product_table_lists_only_kernels(cuda):
    """``bench.profile.kernel_times`` on one SELL product, which runs in the
    program's ``tps.spmv`` and ``tps.launch`` spans: its table lists K1 and
    its reduce pass, and none of the spans' device-side annotations."""
    from tpusparse_torch.bench.profile import kernel_times

    a, x, _ = _workload("full", 1)
    f = SellMatrix.from_dense(a, device=cuda)
    xt = torch.from_numpy(x[0]).to(cuda)
    times = kernel_times(lambda fmt, v: fmt.spmv(v), f, xt)
    assert len(times) == 2, times
    assert all("kernel" in k and not k.startswith("tps.") for k in times), \
        times


def test_sell_mxu_all_zero_matrix(cuda):
    """Every slot a pad (index 0, value 0): the stored tile stays zero."""
    a = np.zeros((384, 256), np.float32)
    f = SellMatrix.from_dense(a, device=cuda)
    assert f.w == 8
    x = generators.random_sparse_batch(5, 384, 0.5, seed=3)
    y = sell_mxu_spmm(f.idx, f.vals, torch.from_numpy(x).to(cuda), n=256)
    torch.cuda.synchronize()
    assert y.shape == (5, 256) and int(torch.count_nonzero(y)) == 0


@pytest.mark.parametrize("batch", [1, 40])
def test_sell_mxu_duplicate_entries(cuda, batch):
    """A CsrMatrix built with repeated (row, column) entries packs them into
    separate slots with one offset: K11 must add them, as the plain
    version does."""
    rng = np.random.default_rng(5)
    m, n, nnz = 300, 260, 6000
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    rows[:400], cols[:400] = rows[400:800], cols[400:800]   # repeats
    rows[:50], cols[:50] = rows[800:850], cols[800:850]     # and triples
    vals = rng.uniform(-1, 1, nnz).astype(np.float32)
    vals[:30] = vals[800:830]                               # equal values
    csr = CsrMatrix.from_coo(m, n, rows, cols, vals)
    f = SellMatrix.from_csr(csr, device=cuda)
    x = generators.random_sparse_batch(batch, m, 0.5, seed=5)
    xt = torch.from_numpy(x).to(cuda)
    y = sell_mxu_spmm(f.idx, f.vals, xt, n=n)
    torch.cuda.synchronize()
    _close(y, sell_mxu_spmm_plain(f.idx, f.vals, xt, n=n), 1e-4)
    _close(y, reference.sgemm_cpu(x, csr.to_dense()), 1e-3)


@pytest.mark.parametrize("batch", [1, 40])
def test_sell_mxu_dense_windows(cuda, batch):
    """A fully dense matrix packs W = 128: two stages of slabs no longer fit
    beside the dense tile, and the kernel runs with one."""
    a = generators.random_sparse_matrix(512, 384, density=1.0, seed=4)
    f = SellMatrix.from_dense(a, device=cuda)
    assert f.w == 128
    x = generators.random_sparse_batch(batch, 512, 0.5, seed=4)
    xt = torch.from_numpy(x).to(cuda)
    y = sell_mxu_spmm(f.idx, f.vals, xt, n=384)
    torch.cuda.synchronize()
    _close(y, sell_mxu_spmm_plain(f.idx, f.vals, xt, n=384), 1e-4)
    _close(y, reference.sgemm_cpu(x, a), 1e-3)


def test_sell_mxu_refuses_unaligned_slabs(cuda):
    a = generators.random_sparse_matrix(256, 256, density=0.2, seed=3)
    f = SellMatrix.from_dense(a, device=cuda)
    buf = torch.empty(f.vals.numel() + 1, dtype=torch.float32, device=cuda)
    vals = buf[1:].view(f.vals.shape)
    vals.copy_(f.vals)
    x = torch.ones((1, 256), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        sell_mxu_spmm(f.idx, vals, x)


def _sass_by_function(lib_path):
    """{kernel name: its SASS text} of a built library, via cuobjdump."""
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                         capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def test_sass_holds_tensor_cores_and_async_copies(cuda):
    """K11's compiled code multiplies on the tensor cores in TF32, three
    products a step (3xTF32, no single-pass path); K2's streams A with
    asynchronous copies (LDGSTS); K1's ring kernel (16 and 32 batch rows)
    bulk-copies its tiles (UBLKCP); K12 and K6's 8-row ring copy with
    cp.async; K9 copies A's rows by 2D tensor copies (UTMALDG) on
    mbarriers (SYNCS) where A allows it, copies x by cp.async and waits on
    its cluster's barrier (UCGABAR)."""
    from tpusparse_torch.kernels import _build
    sass = _sass_by_function(_build.build())
    mxu = {k: v for k, v in sass.items() if "sell_mxu_kernel" in k}
    dense = {k: v for k, v in sass.items() if "dense_kernel" in k}
    assert len(mxu) == 3 and len(dense) == 8, sorted(sass)
    for name, text in mxu.items():
        hmma = [ln for ln in text.splitlines() if "HMMA" in ln]
        assert hmma and all("TF32" in ln for ln in hmma), name
        assert len(hmma) % 3 == 0, (name, len(hmma))
        assert "UBLKCP" in text, name
    for name, text in dense.items():
        assert "LDGSTS" in text or "UBLKCP" in text, name
    ring = {k: v for k, v in sass.items() if "sell_ring_kernel" in k}
    bell = {k: v for k, v in sass.items() if re.search(r"\d+bell_kernelI", k)}
    assert len(ring) == 3 and len(bell) == 4, sorted(sass)
    for name, text in ring.items():        # bulk-copied tiles
        assert "UBLKCP" in text, name
    for name, text in bell.items():        # words, x and values by cp.async
        assert "LDGSTS" in text, name
    ring6 = {k: v for k, v in sass.items() if "bsr_kernelILi8" in k}
    assert len(ring6) == 1, sorted(sass)
    for name, text in ring6.items():       # K6's blocks and x by cp.async
        assert "LDGSTS" in text, name
    asp = {k: v for k, v in sass.items() if "asp_cluster_kernel" in k}
    assert len(asp) == 8, sorted(sass)     # 4 batch tiles x bulk or not
    for name, text in asp.items():         # x (and A) by cp.async
        assert "LDGSTS" in text and "UCGABAR" in text, name
        if "Lb1E" in name:                 # A's rows by a tensor copy
            assert "UTMALDG" in text and "SYNCS" in text, name
    rsell = {k: v for k, v in sass.items() if "rsell_" in k and "_kernel" in k}
    assert len(rsell) == 4, sorted(sass)   # 2, 4 and 8 batch rows; one row


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


@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_dense_spmv_sharded_device_operands_make_no_host_trip(cuda,
                                                              partition):
    """Dense ``spmv_sharded`` on a device A and x at world 1 (NCCL) copies
    nothing back to the host, and gives the host operands' bits."""
    import torch.distributed as dist

    from tpusparse_torch.parallel import initialize, make_mesh, spmv_sharded

    started = not dist.is_initialized()
    initialize()
    try:
        mesh = make_mesh({"n": 1})
        a, x, want = _workload("small", 1)
        at, xt = torch.from_numpy(a).to(cuda), torch.from_numpy(x[0]).to(cuda)
        y_host = spmv_sharded(a, x[0], mesh, partition)
        spmv_sharded(at, xt, mesh, partition)       # the collective's setup
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = spmv_sharded(at, xt, mesh, partition)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(y, y_host)
        _close(y, want[0], 1e-3)
    finally:
        if started:
            dist.destroy_process_group()


def _live_x(m, g, live, batch, seed):
    """x (batch, m) live in a random round(live * ng) of the ng groups of
    g*128 rows, the pattern shared by the batch rows."""
    ng = -(-m // (g * 128))
    rng = np.random.default_rng(seed)
    x = generators.random_sparse_batch(batch, m, 0.5, seed=seed)
    mask = np.zeros(ng * g * 128, bool)
    for gi in rng.choice(ng, size=int(round(live * ng)), replace=False):
        mask[gi * g * 128:(gi + 1) * g * 128] = True
    return np.where(mask[:m], x, 0).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 8, 9])
@pytest.mark.parametrize("live", [0.0, 0.0625, 0.25, 1.0])
def test_awsp_kernel_live_fractions(cuda, live, batch, dtype):
    """K3 at live fractions, by the device plan and the host plan: within
    1e-4 of its plain version and 1e-3 of the oracle, the same bits on two
    calls (its fused sum), and the plan kernel's plan the plain one's."""
    m, n, g = 4096, 1000, 2
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=40)
    f = AwspMatrix.from_dense(a, g=g, dtype=getattr(torch, dtype),
                              device=cuda)
    x = _live_x(m - 3, g, live, batch, seed=41)     # x narrower than A's rows
    xt = torch.from_numpy(x).to(cuda)
    plan, k = device_group_plan(xt, f.n_groups, f.span)
    want = device_group_plan_plain(xt, f.n_groups, f.span)
    assert torch.equal(plan, want[0]) and torch.equal(k, want[1])
    hp = torch.from_numpy(f.plan(x)).to(cuda)
    for p, kk in ((plan, k), (hp, f._count(hp.numel()))):
        y = awsp_spmm(p, kk, f.idx, f.vals, xt, g=g, n=n)
        y2 = awsp_spmm(p, kk, f.idx, f.vals, xt, g=g, n=n)
        torch.cuda.synchronize()
        assert torch.equal(y, y2)
        _close(y, awsp_spmm_plain(p, kk, f.idx, f.vals, xt, g=g, n=n), 1e-4)
        dense = f.to_dense().float().numpy()
        _close(y, reference.sgemm_cpu(np.pad(x, ((0, 0), (0, 3))), dense),
               1e-3)
    if live == 0.0:
        assert int(torch.count_nonzero(y)) == 0


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("shape", [(4096, 8 * 128), (4096, 128),
                                   (1000, 256), (70000, 128)])
def test_group_plan_kernel_matches_plain(cuda, shape, batch):
    """The plan kernel's (plan, k) equal device_group_plan_plain's bit for
    bit: live 0, a few groups, all, x narrower than the groups, x off
    16-byte alignment (its 4-byte loads)."""
    m, span = shape
    ng = -(-m // span)
    rng = np.random.default_rng(m + batch)
    for live in (0.0, 0.0625, 0.25, 1.0):
        x = _live_x(m, span // 128, live, batch, seed=int(rng.integers(99)))
        for xt in (torch.from_numpy(x).to(cuda),
                   torch.from_numpy(np.ascontiguousarray(x[:, :m - 5]))
                   .to(cuda)):
            got = device_group_plan(xt, ng, span)
            want = device_group_plan_plain(xt, ng, span)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        buf = torch.zeros(batch * m + 1, device=cuda)
        off = buf[1:].view(batch, m)
        off.copy_(torch.from_numpy(x))
        got = device_group_plan(off, ng, span)
        want = device_group_plan_plain(off, ng, span)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("batch", [1, 3, 8, 9])
@pytest.mark.parametrize("name", ["run", "flat", "selecting", "full"])
def test_rsell_fused_unpermute(cuda, name, batch):
    """K4 with the unpermute in its second kernel: the same bits as K4 in
    the pack's order then K5, within 1e-4 of the plain K4 + K5; a
    selecting gather (dead lanes, lanes past the pack) reads 0 there."""
    a = _skewed("run" if name == "selecting" else name)
    r = RsellMatrix.from_dense(a, device=cuda)
    np_ = r.padded[1]
    if name == "selecting":
        rng = np.random.default_rng(3)
        src = rng.permutation(np_ + 64)[:500].astype(np.int64) - 32
        src[::9] = -1
        u = unpermute_lanes(src, np_, cuda)
        assert not u.complete
    else:
        u = r.unpermute
        assert u is not None and u.complete
    x = generators.random_sparse_batch(batch, a.shape[0], 0.5, seed=batch)
    xt = torch.from_numpy(x).to(cuda)
    args = (r.cj, r.ct, r.idx, r.vals, xt)
    y = rsell_spmm(*args, n_padded=np_, plan=r._work, unpermute=u)
    y2 = rsell_spmm(*args, n_padded=np_, plan=r._work, unpermute=u)
    pack_order = rsell_spmm(*args, n_padded=np_, plan=r._work)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    assert torch.equal(y, permute_columns(pack_order, u.src))
    _close(y, permute_columns_plain(rsell_spmm_plain(*args, n_padded=np_),
                                    u.src), 1e-4)
    if name != "selecting":
        _close(r.spmm(xt), reference.sgemm_cpu(x, a), 1e-3)


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


def _asp_direct(f, plan, k, x, n, cluster, a_pad=None):
    """K9's C entry with a given cluster size (the wrapper picks one)."""
    from tpusparse_torch.kernels import _build
    a_pad = f.a_pad if a_pad is None else a_pad
    y = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    _build.check(_build.lib().tps_asp_spmm(
        plan.data_ptr(), k.data_ptr(), a_pad.data_ptr(), x.data_ptr(),
        y.data_ptr(), *a_pad.shape, n, x.shape[0], x.shape[1], plan.numel(),
        cluster, x.device.index, _build.stream_of(x)), "asp")
    return y


@pytest.mark.parametrize("batch", [1, 3, 8, 9])
@pytest.mark.parametrize("shape,block_n", [((300, 200), 2048),
                                           ((200, 301), 301),
                                           ((1000, 700), 128),
                                           ((4096, 4096), 2048)])
def test_asp_kernel_clusters_and_odd_shapes(cuda, shape, block_n, batch):
    """K9 at every cluster size, with lda % 4 != 0 (block_n 301: the 4-byte
    copy path), n off 128, x narrower than the rows, a static, a device and
    an explicit plan, and an all-zero X: within 1e-4 of its plain version
    and 1e-3 of the oracle, the same bits on two calls."""
    m, n = shape
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=m + n)
    x = generators.random_sparse_batch(batch, m, 0.5, seed=batch)
    x[:, 128:256] = 0.0                       # a dead window
    f = AspMatrix.from_dense(a, block_n=block_n, device=cuda)
    xt = torch.from_numpy(np.ascontiguousarray(x[:, :m - 5])).to(cuda)
    y_ref = reference.sgemm_cpu(np.where(np.arange(m) < m - 5, x, 0)
                                .astype(np.float32), a)
    plans = {"static": torch.from_numpy(f.plan(x)).to(cuda),
             "device": device_group_plan(xt, f.n_units, 128),
             "explicit": torch.tensor([f.n_units] + list(range(f.n_units)),
                                      dtype=torch.int32, device=cuda)}
    for what, plan in plans.items():
        k = None
        if what == "device":
            plan, k = plan
        k = f._count(plan.numel()) if k is None else k
        want = asp_spmm_plain(plan, k, f.a_pad, xt, n=n)
        for cluster in (1, 2, 4, 8):
            y = _asp_direct(f, plan, k, xt, n, cluster)
            y2 = _asp_direct(f, plan, k, xt, n, cluster)
            torch.cuda.synchronize()
            assert torch.equal(y, y2), (what, cluster)
            _close(y, want, 1e-4)
            _close(y, y_ref, 1e-3)
        y = asp_spmm(plan, k, f.a_pad, xt, n=n)
        _close(y, want, 1e-4)
    zero = torch.zeros((batch, m), device=cuda)
    plan, k = device_group_plan(zero, f.n_units, 128)
    for cluster in (1, 8):
        assert int(torch.count_nonzero(_asp_direct(f, plan, k, zero, n,
                                                   cluster))) == 0


def test_asp_kernel_misaligned_a(cuda):
    """A view of A 4 bytes off 16-byte alignment takes the 4-byte copy
    path in the same kernel."""
    a = generators.random_sparse_matrix(512, 256, density=0.5, seed=5)
    f = AspMatrix.from_dense(a, block_n=128, device=cuda)
    buf = torch.empty(f.a_pad.numel() + 1, device=cuda)
    a_off = buf[1:].view(f.a_pad.shape)
    a_off.copy_(f.a_pad)
    assert a_off.data_ptr() % 16 and a_off.is_contiguous()
    x = torch.from_numpy(generators.random_sparse_batch(8, 512, 0.5,
                                                        seed=6)).to(cuda)
    plan = f._full_plan()
    k = f._count(plan.numel())
    for cluster in (1, 4):
        y = _asp_direct(f, plan, k, x, 256, cluster, a_pad=a_off)
        _close(y, asp_spmm_plain(plan, k, f.a_pad, x, n=256), 1e-4)
    _close(asp_spmm(plan, k, a_off, x, n=256), reference.sgemm_cpu(
        x.cpu().numpy(), a), 1e-3)


@pytest.mark.parametrize("batch", [1, 2, 3, 8, 9, 16])
@pytest.mark.parametrize("name", ["run", "flat", "unsorted"])
def test_rsell_kernel_x_layouts_and_bits(cuda, name, batch):
    """K4 with x of a width off 4 columns and with x 4 bytes off 16-byte
    alignment (its column-a-thread staging), and with x aligned (16-byte
    staging): within 1e-4 of the plain version, the same bits on two
    calls."""
    a = _skewed(name)
    m = a.shape[0]
    f = RsellMatrix.from_dense(a, device=cuda)
    x = generators.random_sparse_batch(batch, m, 0.5, seed=batch + 3)
    buf = torch.zeros(batch * m + 1, device=cuda)
    xs = {"aligned": torch.from_numpy(x).to(cuda),
          "narrow": torch.from_numpy(np.ascontiguousarray(x[:, :m - 3]))
          .to(cuda),
          "offset": buf[1:].view(batch, m)}
    xs["offset"].copy_(xs["aligned"])
    assert xs["offset"].data_ptr() % 16
    for what, xt in xs.items():
        args = (f.cj, f.ct, f.idx, f.vals, xt)
        y = rsell_spmm(*args, n_padded=f.padded[1], plan=f._work)
        y2 = rsell_spmm(*args, n_padded=f.padded[1], plan=f._work)
        torch.cuda.synchronize()
        assert torch.equal(y, y2), what
        _close(y, rsell_spmm_plain(*args, n_padded=f.padded[1]), 1e-4)


def test_public_path_launches_the_kernels(cuda):
    import tpusparse_torch

    a, x, _ = _workload("small", 2)
    wrappers = (sell_spmm, awsp_spmm, dense_cuda, rsell_spmm,
                permute_columns, asp_spmm)
    before = [w.launches for w in wrappers]
    fused = rsell_spmm.unpermutes
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
    # the sorted pack's unpermute rides K4: no K5 launch
    assert [u - v for u, v in zip(after, before)] == [1, 1, 1, 1, 0, 1]
    assert rsell_spmm.unpermutes == fused + 1


# block-structured matrices: name -> (m, n, kind, seed)
BLOCKY = {"pruned": (512, 1024, "pruned", 3), "odd": (200, 300, "blocks", 4),
          "gaps": (256, 512, "gaps", 5), "sparse": (1024, 1024, "sparse", 6),
          "mixed": (512, 1024, "mixed", 7), "full": (4096, 4096, "pruned", 9)}


@functools.cache
def _blocky(name):
    m, n, kind, seed = BLOCKY[name]
    if kind == "pruned":
        return generators.block_pruned_matrix(m, n, block=128, keep_frac=0.3,
                                              fill=0.5, seed=seed)
    if kind == "blocks":
        return generators.random_sparse_matrix(m, n, density=0.3, seed=seed,
                                               distribution="blocks",
                                               block=64)
    if kind == "gaps":             # output groups 1 and 3 hold no entry
        a = generators.random_sparse_matrix(m, n, density=0.2, seed=seed)
        a[:, 128:256] = 0
        a[:, 384:] = 0
        return a
    if kind == "mixed":            # two near-full and two sparse tiles a group
        rng = np.random.default_rng(seed)
        a = np.zeros((m, n), np.float32)
        for g in range(n // 128):
            for k, fill in ((0, 0.97), (1, 0.97), (2, 0.08), (3, 0.08)):
                bi = (g + k) % 4
                tile = rng.uniform(0.1, 1, (128, 128)) * \
                    (rng.random((128, 128)) < fill)
                a[bi * 128:(bi + 1) * 128, g * 128:(g + 1) * 128] = tile
        return a
    return generators.random_sparse_matrix(m, n, density=0.001, seed=seed)


# batch sizes of K6 and K7: every batch tile (1, 2, 4, 8 rows), a partial
# tile, and 2 tiles (9, 16) past the 8 rows any path runs
BLOCK_BATCHES = [1, 2, 3, 5, 8, 9, 16]


@pytest.mark.parametrize("batch", BLOCK_BATCHES)
@pytest.mark.parametrize("name,block_m,ldx", [
    ("pruned", 128, None), ("pruned", 64, None), ("pruned", 512, None),
    ("pruned", 40, 300), ("odd", 128, None), ("odd", 24, None),
    ("odd", 40, 150), ("gaps", 128, None), ("gaps", 8, None),
    ("sparse", 8, None), ("full", 128, None), ("full", 512, None)])
def test_bsr_kernel(cuda, name, block_m, ldx, batch):
    """K6 at block_m 8-512 (part-tile items and items of several blocks),
    zero blocks (empty groups, padding) included, x narrower than the packed
    rows (``ldx``), n off the 128 grid ("odd"): against its plain version,
    the oracle and itself on a second call (the same bits)."""
    a = _blocky(name)
    x = generators.random_sparse_batch(batch, a.shape[0], 0.5, seed=7)
    if ldx is not None:
        x = np.ascontiguousarray(x[:, :ldx])
    f = BsrMatrix.from_dense(a, block_m=block_m, device=cuda)
    assert f.bi.shape[0] > f.n_real or name not in ("gaps", "sparse")
    xt = torch.from_numpy(x).to(cuda)
    args = (f.bi, f.bj, f.blocks, xt)
    n = f.shape[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = bsr_spmm(*args, n_padded=f.padded[1], n=n, plan=f._work)
        y2 = bsr_spmm(*args, n_padded=f.padded[1], n=n, plan=f._work)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    _close(y, bsr_spmm_plain(*args, n_padded=f.padded[1], n=n), 1e-4)
    _close(bsr_spmm(*args, n_padded=f.padded[1], n=n), y, 0.0)  # own plan
    xo = np.zeros((batch, a.shape[0]), np.float32)
    xo[:, :x.shape[1]] = x
    _close(y, reference.sgemm_cpu(xo, a), 1e-3)
    _close(f.spmm(_padded(x, f.padded[0], cuda)), y, 1e-4)


@pytest.mark.parametrize("batch", [1, 5, 9])
@pytest.mark.parametrize("block_m", [8, 128])
def test_bsr_kernel_empty_pack(cuda, block_m, batch):
    """No block at all: the second kernel writes every group's zeros."""
    i32 = torch.zeros(0, dtype=torch.int32, device=cuda)
    blocks = torch.zeros((0, block_m, 128), dtype=torch.float32, device=cuda)
    x = torch.ones((batch, 256), device=cuda)
    y = bsr_spmm(i32, i32, blocks, x, n_padded=384, n=300)
    torch.cuda.synchronize()
    assert y.shape == (batch, 300) and int(torch.count_nonzero(y)) == 0


def _tcsr(name, expect_batch, dev, monkeypatch=None):
    if monkeypatch is not None:                     # mixed tiers
        monkeypatch.setattr(tcsr_mod, "_TIER_SPLIT_BYTES", 0)
    return TcsrMatrix.from_dense(_blocky(name), expect_batch=expect_batch,
                                 device=dev)


def _bsell_tiles(w, dev):
    """Random (bj, bi)-sorted block-SELL tiles of width ``w`` over 5
    windows and 3 groups (group 1 holds none), and the dense A (640, 384)
    they add up to (repeated offsets add)."""
    rng = np.random.default_rng(w)
    nblk = 13
    bj = np.sort(rng.choice([0, 2], nblk)).astype(np.int32)
    bi = rng.integers(0, 5, nblk).astype(np.int32)
    idx = rng.integers(0, 128, (nblk, w, 128)).astype(np.int8)
    vals = (rng.uniform(-1, 1, (nblk, w, 128))
            * (rng.random((nblk, w, 128)) < 0.7)).astype(np.float32)
    a = np.zeros((640, 384), np.float64)
    k, s, r = np.indices(vals.shape).reshape(3, -1)
    np.add.at(a, (bi[k] * 128 + idx[k, s, r], bj[k] * 128 + r),
              vals[k, s, r])
    arrays = [torch.from_numpy(t).to(dev) for t in (bi, bj, idx, vals)]
    return arrays, a.astype(np.float32)


@pytest.mark.parametrize("batch", BLOCK_BATCHES)
@pytest.mark.parametrize("name", ["pruned", "odd", "gaps", "sparse", "full",
                                  "w1", "w8", "w88", "w128", "w88_narrow"])
def test_bsell_kernel(cuda, name, batch):
    """K7 on TCSR's SELL tier, zero tiles (empty groups, padding) included,
    and on random tiles of W 1-128 (items of a part of a tile and of up to
    4 tiles, a group with no tile, x narrower than the windows): against
    its plain version, the oracle and itself on a second call (the same
    bits)."""
    if name.startswith("w"):
        (bi, bj, idx, vals), a = _bsell_tiles(int(name[1:].split("_")[0]),
                                              cuda)
        n_padded, f = 384, None
        plan = bsell_plans(bj.cpu().numpy(), 3, vals.shape[1], cuda)
    else:
        a = _blocky(name)
        f = _tcsr(name, 1, cuda)
        assert f.n_sell > 0
        bi, bj, idx, vals = f.s_bi, f.s_bj, f.idx, f.vals
        n_padded, plan = f.padded[1], f._work
    x = generators.random_sparse_batch(batch, a.shape[0], 0.5, seed=8)
    if name.endswith("narrow"):
        x[:, 500:] = 0                  # x ends inside the last window
        xt = torch.from_numpy(np.ascontiguousarray(x[:, :500])).to(cuda)
    else:
        xt = torch.from_numpy(x).to(cuda)
    args = (bi, bj, idx, vals, xt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = bsell_spmm(*args, n_padded=n_padded, plan=plan)
        y2 = bsell_spmm(*args, n_padded=n_padded, plan=plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    _close(y, bsell_spmm_plain(*args, n_padded=n_padded), 1e-4)
    _close(bsell_spmm(*args, n_padded=n_padded), y, 0.0)      # own plan
    if f is None or f.bsr is None:
        _close(y[:, :a.shape[1]], reference.sgemm_cpu(x, a), 1e-3)
    if f is not None:
        _close(f.spmm(xt), reference.sgemm_cpu(x, a), 1e-3)


@pytest.mark.parametrize("batch", [1, 5, 9])
def test_bsell_kernel_empty_pack(cuda, batch):
    """No tile at all: the second kernel writes every group's zeros."""
    i32 = torch.zeros(0, dtype=torch.int32, device=cuda)
    idx = torch.zeros((0, 8, 128), dtype=torch.int8, device=cuda)
    vals = torch.zeros((0, 8, 128), dtype=torch.float32, device=cuda)
    x = torch.ones((batch, 256), device=cuda)
    y = bsell_spmm(i32, i32, idx, vals, x, n_padded=384, n=300)
    torch.cuda.synchronize()
    assert y.shape == (batch, 300) and int(torch.count_nonzero(y)) == 0


def test_rsell_bits_hold_after_block_kernels(cuda):
    """K4 shares the group reduce pass with K6 and K7 (which run it at 1-4
    batch rows): after K6 and K7 calls of other shapes, K4 gives the same
    bits on two calls."""
    r = RsellMatrix.from_dense(_skewed("run"), device=cuda)
    x = torch.from_numpy(generators.random_sparse_batch(
        3, r.shape[0], 0.5, seed=11)).to(cuda)
    before = rsell_spmm(r.cj, r.ct, r.idx, r.vals, x, n_padded=r.padded[1],
                        plan=r._work)
    f = BsrMatrix.from_dense(_blocky("pruned"), block_m=64, device=cuda)
    t = _tcsr("gaps", 1, cuda)
    for batch in (1, 8, 9):
        bsr_spmm(f.bi, f.bj, f.blocks, torch.ones((batch, 512), device=cuda),
                 n_padded=1024, plan=f._work)
        bsell_spmm(t.s_bi, t.s_bj, t.idx, t.vals,
                   torch.ones((batch, 256), device=cuda),
                   n_padded=t.padded[1], plan=t._work)
    after = [rsell_spmm(r.cj, r.ct, r.idx, r.vals, x, n_padded=r.padded[1],
                        plan=r._work) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(after[0], after[1]) and torch.equal(after[0], before)


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_tcsr_both_tiers_and_empty(cuda, monkeypatch, batch):
    """K7 and K6 in one product (the split charge set to 0, as the CPU test
    does), and an empty pack, which launches neither."""
    a = _blocky("mixed")
    f = _tcsr("mixed", 1, cuda, monkeypatch)
    assert f.n_sell > 0 and f.n_dense > 0
    x = generators.random_sparse_batch(batch, a.shape[0], 0.5, seed=9)
    xt = torch.from_numpy(x).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = f.spmm(xt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _close(y, reference.sgemm_cpu(x, a), 1e-3)
    empty = TcsrMatrix.from_dense(np.zeros((256, 384), np.float32),
                                  device=cuda)
    assert int(torch.count_nonzero(empty.spmm(xt[:, :256]))) == 0


# banded operators (symmetric stencils): name -> (grid, points)
BANDED = {"stencil2d": ((32, 32), None), "stencil3d_27": ((8, 8, 16), 27),
          "odd_n": ((37, 29), None), "full": ((1024, 1024), None)}


@functools.cache
def _banded(name):
    if name == "asym":
        rng = np.random.default_rng(7)
        n = 1100
        ii, jj = np.indices((n, n))
        a = rng.uniform(-1, 1, (n, n)) * np.isin(ii - jj,
                                                 (-300, -5, 0, 2, 129))
        return CsrMatrix.from_dense(a.astype(np.float32))
    dims, points = BANDED[name]
    return generators.stencil_csr(dims, points=points)


def _oracle(csr, x):
    """float64 y = x @ A from the CSR of A.T, never densified."""
    return csr.to_scipy().T.astype(np.float64) @ x.astype(np.float64)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("name", ["stencil2d", "stencil3d_27", "odd_n",
                                  "asym", "full"])
def test_dia_kernel(cuda, name, batch):
    """K8 (one vector a call; ``batch`` vectors in turn), with and without
    sym, n a multiple of 128 or not."""
    c = _banded(name)
    f = DiaMatrix.from_csr(c, device=cuda)
    n = f.shape[1]
    assert f.sym == (name != "asym") and fits(f.offsets, f.sym, n)
    assert name != "odd_n" or n % 128
    for b in range(batch):
        x = generators.random_sparse_vector(n, 0.5, seed=10 + b)
        xt = torch.from_numpy(x).to(cuda)
        torch.cuda.synchronize()
        before = dia_spmv.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = f.spmv(xt)                            # K8 where it fits
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        yk = dia_spmv(f.offsets, f.vals, xt, sym=f.sym, n=n)
        yp = dia_spmv_plain(f.offsets, f.vals, xt, sym=f.sym, n=n)
        _close(yk, yp, 1e-4)
        _close(yk, _oracle(c, x), 1e-3)
        _close(y, _oracle(c, x), 1e-3)
        assert dia_spmv.launches == before + 2        # spmv and yk
    xb = generators.random_sparse_batch(batch, n, 0.5, seed=11)
    yb = f.spmm(torch.from_numpy(xb).to(cuda))        # the shifted form
    _close(yb, np.stack([_oracle(c, v) for v in xb]), 1e-3)


# K8's further shapes: n % 4 != 0 (27-point), an offset past any tile,
# 32 diagonals, negative offsets only, n = 1024 exactly (1-D, 3-point), and
# a sym pack with no main diagonal (term 0's row also has a mirror term)
BANDED_MORE = {"odd_27": ((11, 11, 9), 27), "far": ((5, 5000), None),
               "n1024": ((1024,), None)}


@functools.cache
def _banded_more(name):
    if name in BANDED_MORE:
        dims, points = BANDED_MORE[name]
        return generators.stencil_csr(dims, points=points)
    rng = np.random.default_rng(17)
    n, offs = {"diag32": (4096, rng.choice(np.arange(-3000, 3000), 32,
                                           replace=False)),
               "negative_only": (2048, (-700, -3, -1)),
               "sym_no_main": (2048, (3, 40))}[name]
    ii, jj = np.indices((n, n))
    a = rng.uniform(-1, 1, (n, n)) * np.isin(ii - jj, offs)
    if name == "sym_no_main":              # sym, no main diagonal
        a = a + a.T
    return CsrMatrix.from_dense(a.astype(np.float32))


@pytest.mark.parametrize("name", ["stencil2d", "stencil3d_27", "odd_n",
                                  "asym", "full", "odd_27", "far", "diag32",
                                  "negative_only", "n1024", "sym_no_main"])
def test_dia_kernel_bits(cuda, name):
    """K8 gives ``dia_spmv_plain``'s bits (the same products, added in the
    same order) with the matrix's plan, at every tile, with windows left
    in global memory (the budgets of 16, 48 and 1000 blocks an SM: the
    last stages none), and on a
    strided vals view (row stride n + 12: the 16-byte copies where n
    allows, n + 13: the scalar body)."""
    from tpusparse_torch.kernels.dia_spmv import dia_plan, vec_body
    shapes = [(1024, 8), (1024, 4), (2048, 4), (2048, 2), (4096, 2)]
    c = _banded(name) if name in BANDED or name == "asym" \
        else _banded_more(name)
    f = DiaMatrix.from_csr(c, device=cuda)
    n = f.shape[1]
    assert fits(f.offsets, f.sym, n)
    assert name != "far" or max(f.offsets) > max(t for t, _ in shapes)
    assert name != "diag32" or len(f.offsets) == 32
    assert name != "negative_only" or max(f.offsets) < 0
    assert name != "sym_no_main" or (f.sym and f.offsets == (3, 40))
    x = generators.random_sparse_vector(n, 0.5, seed=21)
    xt = torch.from_numpy(x).to(cuda)
    want = dia_spmv_plain(f.offsets, f.vals, xt, sym=f.sym, n=n)
    plans = [f.plan] + [dia_plan(f.offsets, f.sym, t, b) for t, b in shapes]
    plans += [dia_plan(f.offsets, f.sym, 1024, b) for b in (16, 48, 1000)]
    views = [f.vals]
    for pad in (12, 13):
        big = torch.zeros((len(f.offsets), n + pad), device=cuda)
        big[:, :n] = f.vals
        views.append(big[:, :n])
    assert vec_body(views[2], xt, n) is False
    for v in views:
        for p in plans:
            y = dia_spmv(f.offsets, v, xt, sym=f.sym, n=n, plan=p)
            torch.cuda.synchronize()
            assert torch.equal(y, want), (p.tile, p.smem_bytes, v.stride())
    _close(want, _oracle(c, x), 1e-3)


@pytest.mark.parametrize("name", ["stencil2d", "stencil3d_27", "odd_n",
                                  "asym", "full", "far", "sym_no_main"])
def test_dia_kernel_strips_bits(cuda, name):
    """K8 with halo strips gives ``dia_spmv_plain``'s bits: random strips
    (x on both sides, the vals rows on the left when sym) and the wrap
    strips of a ring of one rank (x's own edges, the vals strip zeroed),
    with the matrix's plan and with every window left in global memory, in
    the 16-byte body and the scalar body (vals row stride n + 13, or a
    strip off 16 bytes). The wrap strips meet coefficients the packer
    zeroed: the result is the one without strips, bit for bit."""
    from tpusparse_torch.kernels.dia_spmv import (dia_plan, strip_width,
                                                  vec_body)
    c = _banded(name) if name in BANDED or name == "asym" \
        else _banded_more(name)
    f = DiaMatrix.from_csr(c, device=cuda)
    n, k = f.shape[1], len(f.offsets)
    hs = strip_width(f.offsets, f.sym)
    assert fits(f.offsets, f.sym, n) and hs <= n
    x = torch.from_numpy(generators.random_sparse_vector(n, 0.5, seed=22)) \
        .to(cuda)
    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    strips = {"random": (rnd(hs), rnd(hs), rnd(k, hs) if f.sym else None),
              "wrap": (x[-hs:].clone(), x[:hs].clone(),
                       torch.zeros(k, hs, device=cuda) if f.sym else None)}
    shifted = torch.zeros(hs + 1, device=cuda)[1:]     # off 16 bytes
    plans = [f.plan, dia_plan(f.offsets, f.sym, 1024, 1000)]
    big = torch.zeros((k, n + 13), device=cuda)
    big[:, :n] = f.vals
    views = [f.vals, big[:, :n]]
    none = dia_spmv_plain(f.offsets, f.vals, x, sym=f.sym, n=n)
    for label, (sl, sr, vs) in strips.items():
        kw = dict(xstrip_l=sl, xstrip_r=sr, vstrip=vs)
        want = dia_spmv_plain(f.offsets, f.vals, x, sym=f.sym, n=n, **kw)
        if label == "wrap":
            assert torch.equal(want, none)
        for v in views:
            for p in plans:
                y = dia_spmv(f.offsets, v, x, sym=f.sym, n=n, plan=p, **kw)
                torch.cuda.synchronize()
                assert torch.equal(y, want), (label, p.tile, v.stride())
        shifted.copy_(sl)
        assert not vec_body(f.vals, x, n, shifted)
        y = dia_spmv(f.offsets, f.vals, x, sym=f.sym, n=n,
                     **dict(kw, xstrip_l=shifted))
        torch.cuda.synchronize()
        assert torch.equal(y, want), (label, "strip off 16 bytes")
    before = dia_spmv.strip_launches
    dia_spmv(f.offsets, f.vals, x, sym=f.sym, n=n)
    assert dia_spmv.strip_launches == before


def test_dia_public_call_one_launch(cuda):
    """``DiaMatrix.spmv`` launches K8 once a call, with no host sync, on
    the plan the matrix built once."""
    c = _banded("full")
    f = DiaMatrix.from_csr(c, device=cuda)
    xs = [torch.from_numpy(generators.random_sparse_vector(
        f.shape[0], 0.5, seed=30 + i)).to(cuda) for i in range(3)]
    f.spmv(xs[0])
    plan = f.plan
    torch.cuda.synchronize()
    before = dia_spmv.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = [f.spmv(x) for x in xs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 3 and f.plan is plan
    for x, y in zip(xs, ys):
        assert torch.equal(y, dia_spmv_plain(f.offsets, f.vals, x,
                                             sym=f.sym, n=f.shape[1]))


def test_sass_k8_copies(cuda):
    """K8 stages its windows by cp.async (LDGSTS): 16 bytes a copy in its
    16-byte body (LDGSTS.E.BYPASS.128), 4 in its scalar body; each body a
    kernel with no strips and one with halo strips."""
    from tpusparse_torch.kernels import _build
    sass = _sass_by_function(_build.build())
    dia = {k: v for k, v in sass.items()
           if "dia_tile_kernel" in k or "dia_strip_kernel" in k}
    assert len(dia) == 4, sorted(sass)
    assert sum("dia_strip_kernel" in k for k in dia) == 2, sorted(dia)
    for name, text in dia.items():
        assert "LDGSTS" in text, name
        assert ("LDGSTS.E.BYPASS.128" in text) == ("ILb1E" in name), name


def test_block_and_banded_public_paths_launch_the_kernels(cuda):
    import tpusparse_torch

    a = _blocky("pruned")
    x = generators.random_sparse_batch(8, a.shape[0], 0.5, seed=12)
    wrappers = (bsell_spmm, bsr_spmm, dia_spmv)
    before = [w.launches for w in wrappers]
    f1 = tpusparse_torch.auto_format(a, expect_batch=1)
    f8 = tpusparse_torch.auto_format(a, expect_batch=8)
    assert isinstance(f1, TcsrMatrix) and isinstance(f8, TcsrMatrix)
    assert (f1.n_dense, f8.n_sell) == (0, 0)
    _close(tpusparse_torch.spmv(f1, x[0]), reference.sgemv_cpu(x[0], a), 1e-3)
    _close(tpusparse_torch.spmm(f8, x), reference.sgemm_cpu(x, a), 1e-3)
    c = _banded("stencil2d")
    d = tpusparse_torch.auto_format(c)
    assert isinstance(d, DiaMatrix) and d.sym and d.offsets == (0, 1, 32)
    v = generators.random_sparse_vector(1024, 0.5, seed=13)
    _close(tpusparse_torch.spmv(d, v), _oracle(c, v), 1e-3)
    after = [w.launches for w in wrappers]
    assert all(u == w + 1 for u, w in zip(after, before))


@functools.cache
def _twin(size):
    m, n = SIZES[size]
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=0)
    return a, _TwinPack(CsrMatrix.from_dense(a))


def _dvals_oracle(s, u, v):
    """float64 sum_b u[b, row(slot)] * v[b, col(slot)] on the live slots."""
    live = s >= 0
    j, t, _, r = torch.nonzero(live, as_tuple=True)
    rows, cols = t * 128 + s[live].long(), j * 128 + r
    acc = torch.zeros(rows.numel(), dtype=torch.float64, device=s.device)
    for b in range(u.shape[0]):
        acc += u[b].double()[rows] * v[b].double()[cols]
    return live, acc


@pytest.mark.parametrize("batch", [1, 3, 8, 12])
@pytest.mark.parametrize("size", list(SIZES))
def test_sell_grad_kernel(cuda, size, batch):
    """K10 in both roles of the backward (forward plane with (x, g),
    transpose plane with (g, x)); B = 12 takes the generic body."""
    a, pack = _twin(size)
    m, n = a.shape
    x = torch.from_numpy(generators.random_sparse_batch(batch, m, 0.5,
                                                        seed=batch)).to(cuda)
    g = torch.from_numpy(np.random.default_rng(batch).uniform(
        -1, 1, (batch, n)).astype(np.float32)).to(cuda)
    for plane, u, v in ((pack.s_f, x, g), (pack.s_t, g, x)):
        s = torch.from_numpy(plane).to(cuda)
        before = sell_dvals.launches
        d = sell_dvals(s, u, v)
        torch.cuda.synchronize()
        assert sell_dvals.launches == before + 1
        _close(d, sell_dvals_plain(s, u, v), 1e-4)
        assert not d[s < 0].any()                 # pads exactly 0
        live, want = _dvals_oracle(s, u, v)
        _close(d[live], want, 1e-3)


@pytest.mark.parametrize("batch", [1, 3])
def test_trainable_path_launches_and_grads(cuda, batch):
    """K1 x2 and K10 x2 for a backward that asks for dx; K1 x1 and K10 x2
    when x is data; the gradients agree with the CPU's plain versions."""
    a, _ = _twin("unaligned")
    c = CsrMatrix.from_dense(a)
    x = generators.random_sparse_batch(batch, a.shape[0], 0.5, seed=5)
    x = x[0] if batch == 1 else x
    g = np.random.default_rng(6).uniform(-1, 1, x.shape[:-1] + (
        a.shape[1],)).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        apply, params, _, _ = trainable_linear(c, device=dev)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        torch.cuda.synchronize()
        k1, k10 = sell_spmm.launches, sell_dvals.launches
        apply(params, xt).backward(torch.from_numpy(g).to(dev))
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert (sell_spmm.launches - k1, sell_dvals.launches - k10) == \
                (2, 2)
            k1, k10 = sell_spmm.launches, sell_dvals.launches
            apply(params, x).backward(torch.from_numpy(g).to(dev))
            assert (sell_spmm.launches - k1, sell_dvals.launches - k10) == \
                (1, 2)
        grads[dev.type] = (xt.grad, params["vals"].grad, params["vals_t"].grad)
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got is not None and want is not None
    _close(grads["cuda"][0], grads["cpu"][0], 1e-4)
    # the second CUDA backward accumulated a second copy of the values' grads
    for k in (1, 2):
        _close(grads["cuda"][k], 2 * grads["cpu"][k], 1e-4)


def test_training_step_has_no_host_sync(cuda):
    """SparseLinear + a dense head: forward, backward, SGD step and resync,
    with host syncs made errors; the loss falls."""
    torch.manual_seed(0)
    a, _ = _twin("small")
    m, n = a.shape
    hidden = SparseLinear.from_dense(a, use_bias=True, activation=torch.relu)
    model = torch.nn.Sequential(hidden, torch.nn.Linear(n, 16).to(cuda))
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    x = torch.from_numpy(generators.random_sparse_batch(
        8, m, 0.5, seed=7)).to(cuda) * 0.1
    target = torch.zeros((8, 16), device=cuda)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = ((model(x) - target) ** 2).mean()
            loss.backward()
            opt.step()
            hidden.resync()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]
    for k in ("vals", "vals_t"):
        assert not getattr(hidden, k).detach()[~hidden.masks[k]].any()


@pytest.mark.parametrize("batch", [1, 3, 8, 12])
@pytest.mark.parametrize("size,block_m", [("small", 128), ("small", 256),
                                          ("unaligned", 512), ("odd", 512),
                                          ("full", 512), ("full", 256)])
def test_bell_kernel(cuda, size, block_m, batch):
    """K12 at block_m 128, 256 and 512 (512 clamps to 256 on the unaligned
    and odd sizes), m off the block grid, B = 12 over two batch tiles."""
    a, x, y_ref = _workload(size, batch)
    f = BellMatrix.from_dense(a, block_m=block_m, device=cuda)
    xt = torch.from_numpy(x).to(cuda)
    before = bell_spmm.launches
    y = bell_spmm(f.bitmap, f.vals, xt, block_m=f.block_m, n=f.shape[1])
    torch.cuda.synchronize()
    assert bell_spmm.launches == before + 1
    _close(y, bell_spmm_plain(f.bitmap, f.vals, xt, block_m=f.block_m,
                              n=f.shape[1]), 1e-4)
    _close(y, y_ref, 1e-3)
    _close(f.spmv(xt[0]), y_ref[0], 1e-3)


@pytest.mark.parametrize("kind", ["dense", "empty"])
def test_bell_kernel_dense_and_empty(cuda, kind):
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (256, 128)).astype(np.float32) \
        if kind == "dense" else np.zeros((256, 128), np.float32)
    f = BellMatrix.from_dense(a, block_m=256, device=cuda)
    x = generators.random_sparse_batch(8, 256, 0.5, seed=1)
    _close(f.spmm(torch.from_numpy(x).to(cuda)), reference.sgemm_cpu(x, a),
           1e-3)


@pytest.mark.parametrize("batch", [1, 3, 8, 32, 40])
@pytest.mark.parametrize("size", ["small", "unaligned", "odd", "full"])
def test_sell_mxu_kernel(cuda, size, batch):
    """K11; B = 40 runs two batch tiles of 32. Row 0 set to 1: every column
    has an offset-0 entry that the pad slots alias."""
    m, n = SIZES[size]
    a = generators.random_sparse_matrix(m, n, density=0.2, seed=61)
    a[0, :] = 1.0
    x = generators.random_sparse_batch(batch, m, 0.5, seed=61)
    f = SellMatrix.from_dense(a, device=cuda)
    xt = torch.from_numpy(x).to(cuda)
    before = sell_mxu_spmm.launches
    y = sell_mxu_spmm(f.idx, f.vals, xt, n=n)
    torch.cuda.synchronize()
    assert sell_mxu_spmm.launches == before + 1
    _close(y, sell_mxu_spmm_plain(f.idx, f.vals, xt, n=n), 1e-4)
    _close(y, reference.sgemm_cpu(x, a), 1e-3)


def test_binned_public_path_launches(cuda):
    """Binned SELL on the skew matrix: K1 once per bucket, then K5 once on
    the buckets' outputs in place, with no torch.cat between (the
    profiler sees no copy kernel)."""
    a = _skewed("full")
    f = BinnedSellMatrix.from_dense(a, device=cuda)
    x = generators.random_sparse_batch(8, a.shape[0], 0.5, seed=0)
    xt = torch.from_numpy(x).to(cuda)
    torch.cuda.synchronize()
    k1, k5 = sell_spmm.launches, permute_columns.launches
    y8 = f.spmm(xt)
    y1 = f.spmv(xt[0])
    torch.cuda.synchronize()
    assert sell_spmm.launches - k1 == 2 * len(f.widths)
    assert permute_columns.launches - k5 == 2
    _close(y8, reference.sgemm_cpu(x, a), 1e-3)
    _close(y1, reference.sgemv_cpu(x[0], a), 1e-3)
    cats = []
    cat = torch.cat
    torch.cat = lambda *args, **kw: cats.append(1) or cat(*args, **kw)
    try:
        f.spmm(xt)
    finally:
        torch.cat = cat
    assert not cats


@pytest.mark.parametrize("name", ["ell_torch", "bell_cuda",
                                  "sell_binned_cuda", "bsr_cuda",
                                  "tcsr_cuda", "rsell_cuda", "asp_cuda"])
def test_full_registry_on_the_card(cuda, name):
    a, x, y_ref = _workload("small", 3)
    e = next(e for e in registry(full=True) if e["name"] == name)
    _close(e["run"](e["prepare"](a, cuda), torch.from_numpy(x).to(cuda)),
           y_ref, 1e-3)


# -- the solver path: CG on K8, AMG across devices, packs saved on the card


def test_cg_on_k8_matches_its_plain_version(cuda):
    from tpusparse_torch.solve import cg

    csr = generators.stencil_csr((128, 128))
    d = DiaMatrix.from_csr(csr, device=cuda)
    n = d.shape[1]
    assert fits(d.offsets, d.sym, n)
    b = torch.from_numpy(generators.random_sparse_vector(n, 0.5, 0)).to(cuda)
    k0 = dia_spmv.launches
    z1, i1 = cg(d, b, tol=1e-5)
    assert dia_spmv.launches - k0 == i1["iters"] + 1
    z2, i2 = cg(lambda v: dia_spmv_plain(d.offsets, d.vals, v, sym=d.sym,
                                         n=n), b, tol=1e-5)
    assert i1["iters"] == i2["iters"] and torch.equal(z1, z2)
    sp = csr.to_scipy().astype(np.float64)
    res = np.linalg.norm(sp @ z1.double().cpu().numpy() - b.cpu().numpy())
    assert res <= 1e-4 * np.linalg.norm(b.cpu().numpy())


def test_amg_vcycle_card_against_cpu(cuda, tmp_path):
    from tpusparse_torch.amg import SmoothedAggregationAMG, smoothed_aggregation

    csr = generators.stencil_csr((256, 256))
    amg = smoothed_aggregation(csr, device=cuda)
    assert [type(lv.p).__name__ for lv in amg.levels[:2]] == \
        ["RsellMatrix", "RsellMatrix"]
    amg.save(str(tmp_path / "amg.npz"))
    cpu = SmoothedAggregationAMG.load(str(tmp_path / "amg.npz"),
                                      device="cpu")
    back = SmoothedAggregationAMG.load(str(tmp_path / "amg.npz"),
                                       device=cuda)
    r = torch.from_numpy(generators.random_sparse_vector(
        csr.shape[0], 0.5, 1)).to(cuda)
    k4, k8 = rsell_spmm.launches, dia_spmv.launches
    v = amg(r)
    assert rsell_spmm.launches > k4 and dia_spmv.launches > k8
    vc = cpu(r.cpu())
    err = torch.linalg.norm(v.cpu().double() - vc.double())
    assert float(err) <= 1e-4 * float(torch.linalg.norm(vc.double()))
    assert torch.equal(back(r), v)
    z, info = amg.solve(r, tol=1e-5)
    sp = csr.to_scipy().astype(np.float64)
    res = np.linalg.norm(sp @ z.double().cpu().numpy() - r.cpu().numpy())
    assert info["iters"] <= 12
    assert res <= 1e-4 * float(torch.linalg.norm(r.double()))


@pytest.mark.parametrize("kind", ["sell", "rsell_sorted", "tcsr", "dia",
                                  "bell", "binned", "asp"])
def test_io_round_trip_on_the_card(cuda, tmp_path, kind):
    from tpusparse_torch.formats import io

    a = generators.random_sparse_matrix(512, 384, density=0.15, seed=2,
                                        distribution="powerlaw")
    band = np.ascontiguousarray(np.tril(np.triu(a[:384, :384], -3), 3))
    make = {"sell": lambda: SellMatrix.from_dense(a, device=cuda),
            "rsell_sorted": lambda: RsellMatrix.from_dense(a, device=cuda),
            "tcsr": lambda: TcsrMatrix.from_dense(a, device=cuda),
            "dia": lambda: DiaMatrix.from_dense(band, device=cuda),
            "bell": lambda: BellMatrix.from_dense(a, block_m=256,
                                                  device=cuda),
            "binned": lambda: BinnedSellMatrix.from_dense(a, device=cuda),
            "asp": lambda: AspMatrix.from_dense(a, block_n=128,
                                                device=cuda)}
    f = make[kind]()
    path = str(tmp_path / f"{kind}.npz")
    io.save(path, f)
    back = io.load(path)                              # device=None: the card
    assert back.device.type == "cuda"
    _, aux0, dt0, arr0 = io.encode(f)
    _, aux1, dt1, arr1 = io.encode(back)
    assert (aux0, dt0) == (aux1, dt1)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(arr0, arr1))
    m = f.shape[0]
    x = torch.from_numpy(generators.random_sparse_vector(m, 0.5, 3)).to(cuda)
    assert torch.equal(back.spmv(x), f.spmv(x))


# -- the sharded training and AMG paths at world size 1 over NCCL -----------


@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from tpusparse_torch.parallel import initialize, make_mesh

    initialize()                                  # NCCL on cuda:0
    assert dist.get_backend() == "nccl"
    yield make_mesh({"n": 1})
    dist.destroy_process_group()


@pytest.mark.parametrize("batch", [1, 8])
def test_sharded_train_step_world1_nccl(cuda, nccl_mesh, batch):
    """``trainable_linear_sharded`` at one rank: K1 twice and K10 twice a
    step, and the unsharded step's y, dx and value gradients (1e-5; the
    same kernels on the same planes)."""
    from tpusparse_torch import trainable_linear, trainable_linear_sharded
    from tpusparse_torch.kernels.sell_grad import sell_dvals

    a = generators.random_sparse_matrix(1024, 1536, density=0.5, seed=61)
    csr = CsrMatrix.from_dense(a)
    aps, ps, _, resync = trainable_linear_sharded(csr, nccl_mesh)
    ap1, p1, _, _ = trainable_linear(csr)
    x0 = generators.random_sparse_batch(batch, 1024, 0.5, seed=62)
    g = torch.from_numpy(np.random.default_rng(63).uniform(
        -1, 1, (batch, 1536)).astype(np.float32)).to(cuda)
    xs, x1 = (torch.from_numpy(x0).to(cuda).requires_grad_()
              for _ in range(2))
    torch.cuda.synchronize()
    sell_spmm.launches = sell_dvals.launches = 0
    y = aps(ps, xs)
    y.backward(g)
    torch.cuda.synchronize()
    assert (sell_spmm.launches, sell_dvals.launches) == (2, 2)
    y1 = ap1(p1, x1)
    y1.backward(g)
    for u, v in ((y, y1), (xs.grad, x1.grad),
                 (ps["vals"].grad, p1["vals"].grad),
                 (ps["vals_t"].grad, p1["vals_t"].grad)):
        _close(u.detach(), v.detach().cpu(), 1e-5)
    _close(y.detach(), x0.astype(np.float64) @ a.astype(np.float64), 1e-3)
    before = ps["vals_t"].detach().clone()
    resync(ps)
    assert torch.equal(ps["vals_t"], before)     # no step: nothing drifted


def _sharded_amg_case(kind):
    if kind == "grid":
        return generators.stencil_csr((48, 48)), dict(aggregation="grid")
    return generators.mesh_csr(48, 48, seed=4), dict(dense_cutoff=512)


@pytest.mark.parametrize("kind", ["grid", "greedy"])
def test_sharded_amg_world1_nccl(cuda, nccl_mesh, kind):
    """Side-48 AMG at one rank: grid placed with ``shard`` (level 0 through
    the halo partition, K8) and greedy built with ``mesh=`` (ragged-SELL
    shards, K4), each in the unsharded build's CG iterations; grid's z
    within 1e-5, greedy's residual within max(2 x the unsharded, 1e-5)."""
    from tpusparse_torch.amg import smoothed_aggregation

    c, kw = _sharded_amg_case(kind)
    b = torch.from_numpy(np.random.default_rng(64).uniform(
        -1, 1, c.shape[0]).astype(np.float32)).to(cuda)
    h0 = smoothed_aggregation(c, **kw)
    if kind == "grid":
        sh = h0.shard(nccl_mesh)
        assert type(sh.levels[0].a).__name__ == "_HaloDia"
    else:
        sh = smoothed_aggregation(c, mesh=nccl_mesh, **kw)
        assert sh.levels[0].fmt == "rsell-shard"
    tol = 1e-5 if kind == "grid" else 1e-6
    z0, i0 = h0.solve(b, tol=tol)
    torch.cuda.synchronize()
    dia_spmv.launches = rsell_spmm.launches = 0
    z, info = sh.solve(b, tol=tol)
    torch.cuda.synchronize()
    assert info["iters"] == i0["iters"]
    if kind == "grid":
        assert dia_spmv.launches > 0
        _close(z, z0.cpu(), 1e-5)
    else:
        assert rsell_spmm.launches > 0
        sp = c.to_scipy().astype(np.float64)
        bh = b.cpu().numpy().astype(np.float64)

        def relres(zz):
            return np.linalg.norm(sp @ zz.double().cpu().numpy() - bh) \
                / np.linalg.norm(bh)

        assert relres(z) <= max(2 * relres(z0), 1e-5)


def test_moe_layers_on_the_card(cuda):
    """DeepSeek-V2's FFN layers (``moe.ffn_layer``) on the card against
    the plain float64 reference, at test_torch_moe.py's size (hidden 256,
    16 experts of width 128, top 6, 2 shared, a dense layer of 320), 1e-5
    as there; the card's layer and the CPU's plain one route alike; the
    device counter counts the routed experts' union with no host read."""
    from tpusparse_torch import moe
    from tpusparse_torch.testing import moe_reference as ref

    hidden, width, experts, dense = 256, 128, 16, 320
    cfg = {"hidden_size": hidden, "intermediate_size": dense,
           "moe_intermediate_size": width, "n_routed_experts": experts,
           "num_experts_per_tok": 6, "n_shared_experts": 2,
           "scoring_func": "softmax", "topk_method": "greedy",
           "norm_topk_prob": False, "routed_scaling_factor": 1,
           "rms_norm_eps": 1e-6, "hidden_act": "silu",
           "first_k_dense_replace": 1, "moe_layer_freq": 1}
    g = torch.Generator().manual_seed(23)

    def mat(rows, cols):
        return ref.prune_half(torch.randn(rows, cols, generator=g)
                              / rows ** 0.5)

    def triple(w):
        return mat(hidden, w), mat(hidden, w), mat(w, hidden)

    norm = 1 + 0.25 * torch.rand(hidden, generator=g)
    layers = [{"norm": norm, "mlp": triple(dense)},
              {"norm": norm,
               "router": torch.randn(hidden, experts, generator=g)
               / hidden ** 0.5,
               "experts": [triple(width) for _ in range(experts)],
               "shared": triple(2 * width)}]
    for batch in (2, 8):
        x = torch.randn(batch, hidden, generator=g)
        for i, p in enumerate(layers):
            m = moe.ffn_layer(cfg, i, p, expect_batch=batch, device=cuda)
            plain = moe.ffn_layer(cfg, i, p, expect_batch=batch,
                                  device="cpu")
            if i == 0:
                y, want = m(x.to(cuda)), ref.dense_layer(x, p, cfg)
                assert (y.cpu() - plain(x)).abs().max() < 1e-5
            else:
                y, w = m(x.to(cuda), with_weights=True)
                yp, wp = plain(x, with_weights=True)
                want = ref.moe_layer(x, p, cfg)
                assert torch.equal(w.cpu() != 0, wp != 0)
                live = int((w != 0).any(dim=0).sum())
                assert m.counters()["moe.live_groups"] == live
            torch.cuda.synchronize()
            assert (y.cpu().double() - want).abs().max() < 1e-5
