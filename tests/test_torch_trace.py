"""The port's spans (``tpusparse_torch/trace.py``) on the CPU: nothing
without a profiler; under one, a format's public product encloses its
kernel wrapper's span, every read of a solver's stopping test is one
``tps.stop`` span, and CG gives the same bits either way.
``auto_format.stats_s`` rises with each call."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpusparse_torch import solve, trace
from tpusparse_torch.formats.auto import auto_format
from tpusparse_torch.formats.dia import DiaMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.kernels.dia_spmv import fits
from tpusparse_torch.testing import generators

CPU = torch.device("cpu")


def _spans(prof, prefix="tps."):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("tps.spmv"), trace.span("tps.stop")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    assert trace.spanned("tps.launch")(lambda v: v + 1)(1) == 2


def _sell():
    a = generators.random_sparse_matrix(256, 384, density=0.3, seed=1)
    return SellMatrix.from_dense(a, device=CPU), 256


def _dia():
    f = DiaMatrix.from_csr(generators.stencil_csr((32, 32)), device=CPU)
    assert fits(f.offsets, f.sym, f.shape[0])     # K8's wrapper, not the
    return f, f.shape[0]                          # shifted form


@pytest.mark.parametrize("make", [_sell, _dia], ids=["sell", "dia"])
def test_product_records_entry_enclosing_one_launch(make):
    f, m = make()
    x = torch.from_numpy(generators.random_sparse_vector(m, 0.5, seed=2))
    want = f.spmv(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = f.spmv(x)
    spans = _spans(prof)
    assert sorted(e.name for e in spans) == ["tps.launch", "tps.spmv"]
    entry = next(e for e in spans if e.name == "tps.spmv")
    launch = next(e for e in spans if e.name == "tps.launch")
    assert entry.time_range.start <= launch.time_range.start
    assert launch.time_range.end <= entry.time_range.end
    assert torch.equal(y, want)


def _laplacian():
    return DiaMatrix.from_csr(generators.stencil_csr((12, 12)), device=CPU)


# read-backs of one converged solve, from what it returns
READS = {
    "cg": lambda info: info["iters"] + 1,
    "bicgstab": lambda info: info["iters"] + 1,
    "gmres": lambda info: info["iters"] // 30 + 1,     # one a cycle
    "cg_multi": lambda info: info["iters"] + 1,
}


@pytest.mark.parametrize("name", list(READS))
def test_each_stopping_read_is_one_stop_span(name):
    a = _laplacian()
    n = a.shape[0]
    rng = np.random.default_rng(3)
    shape = (3, n) if name == "cg_multi" else (n,)
    b = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = getattr(solve, name)(a, b, tol=1e-5, maxiter=2000)
    reads = READS[name](info)
    assert 0 < info["iters"] < 2000
    assert [e.name for e in _spans(prof)
            if e.name == "tps.stop"] == ["tps.stop"] * reads


def test_cg_is_the_same_with_the_profiler_on():
    a = _laplacian()
    b = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, a.shape[0]).astype(np.float32))
    x_off, info_off = solve.cg(a, b, tol=1e-6)
    with profile(activities=[ProfilerActivity.CPU]):
        x_on, info_on = solve.cg(a, b, tol=1e-6)
    assert info_on["iters"] == info_off["iters"] > 0
    assert torch.equal(x_on, x_off)


def test_stats_seconds_rise_with_each_call():
    a = generators.random_sparse_matrix(256, 256, density=0.3, seed=5)
    for _ in range(2):
        before = auto_format.stats_s
        auto_format(a, device=CPU)
        assert auto_format.stats_s > before
