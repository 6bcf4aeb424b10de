"""K1's launch plans (``kernels/sell_spmv.py`` ``SellPlan``) on the CPU,
where a plan runs the plain version: a ``SellMatrix`` builds one per
(batch rows, x width, device, stream) and reuses it, counted by
``sell_plan.builds`` and ``sell_plan.hits``; a replaced ``vals``, ``idx``
or ``scales`` makes it build anew, counted by ``sell_plan.rebuilds``; the
checks raise what they raised before plans (on ``meta`` tensors, which
take the card's checks and are refused at the device check). The card's
side is in ``tests/test_torch_cuda.py``. The benchmark's reader of the
counters, ``benchmarks/metrics/plan_rebuild_share.py``, is checked at the
end, on these products and on hand-made program modules.

This file imports no JAX."""

import importlib.util
import pathlib
import re
import sys
import types

import pytest
import torch

from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.kernels.sell_spmv import (sell_plan, sell_spmm,
                                               sell_spmm_plain)
from tpusparse_torch.testing import generators

M, N = 300, 260


@pytest.fixture
def sell():
    a = generators.random_sparse_matrix(M, N, density=0.3, seed=4)
    return SellMatrix.from_dense(a, device="cpu")


def _x(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 2 - 1


def _counts():
    return sell_plan.builds, sell_plan.hits, sell_plan.rebuilds


def _delta(before):
    """(builds, hits, rebuilds) since ``before``."""
    return tuple(now - then for now, then in zip(_counts(), before))


def test_one_build_per_key_then_hits(sell):
    before = _counts()
    for _ in range(3):
        sell.spmv(_x(M))
    assert _delta(before) == (1, 2, 0)
    for _ in range(2):
        sell.spmm(_x(4, M))             # another batch: its own plan
        sell.spmm(_x(4, 200))           # a narrower x: its own plan
    assert _delta(before) == (3, 4, 0)
    sell.spmm(_x(1, M))                 # B = 1 shares spmv's plan
    assert _delta(before) == (3, 5, 0)
    assert sorted(sell._plans) == [(1, M, -1, 0), (4, 200, -1, 0),
                                   (4, M, -1, 0)]


def test_numpy_and_strided_inputs_reuse_the_plan(sell):
    """An x that misses the planned path's check (numpy, a strided view)
    goes through ``as_input`` and the full path, to the same plan."""
    x = _x(M, 2)[:, 0]
    want = sell.spmv(x.contiguous())
    before = _counts()
    assert torch.equal(sell.spmv(x.numpy()), want)
    assert torch.equal(sell.spmv(x), want)
    assert _delta(before) == (0, 2, 0)


def test_replaced_vals_build_anew(sell):
    x = _x(M)
    y = sell.spmv(x)
    before = _counts()
    sell.vals = sell.vals * 2           # a new tensor: the plan is stale
    y2 = sell.spmv(x)
    assert _delta(before) == (1, 0, 1)
    assert sell._plans[(1, M, -1, 0)].vals is sell.vals
    assert torch.equal(y2, y * 2)
    sell.vals.mul_(0.5)                 # in place: the plan still holds
    assert torch.equal(sell.spmv(x), y)
    assert _delta(before) == (1, 1, 1)


def test_every_stale_product_counts_a_rebuild(sell):
    """A plan gone stale before each product: the key's first product is a
    build, each later one a rebuild, and none a hit."""
    x = _x(M)
    before = _counts()
    for _ in range(4):
        sell.spmv(x)
        sell.vals = sell.vals.clone()
    assert _delta(before) == (4, 0, 3)
    assert len(sell._plans) == 1


@pytest.mark.parametrize("field", ["idx", "scales"])
def test_replaced_idx_or_scales_build_anew(field):
    a = generators.random_sparse_matrix(M, N, density=0.3, seed=5)
    f = SellMatrix.from_dense(a, dtype="int8", device="cpu")
    x = _x(M)
    y = f.spmv(x)
    before = _counts()
    setattr(f, field, getattr(f, field).clone())
    assert torch.equal(f.spmv(x), y)
    assert _delta(before) == (1, 0, 1)


@pytest.mark.parametrize("lane", [None, torch.bfloat16, "int8"])
def test_spmv_is_a_vector_equal_to_the_plain_version(lane):
    a = generators.random_sparse_matrix(M, N, density=0.3, seed=6)
    f = SellMatrix.from_dense(a, dtype=lane, device="cpu")
    x = _x(M, seed=1)
    want = sell_spmm_plain(f.idx, f.vals, x[None, :], scales=f.scales,
                           n=N)[0]
    for _ in range(2):                  # built, then reused
        y = f.spmv(x)
        assert y.shape == (N,) and torch.equal(y, want)
    ys = f.spmm(torch.stack([x, x]))
    assert ys.shape == (2, N) and torch.equal(ys[1], want)


def test_direct_call_builds_a_plan_for_one_call(sell):
    x = _x(3, M)
    before = _counts()
    y = sell_spmm(sell.idx, sell.vals, x, n=N)
    assert _delta(before) == (1, 0, 0)
    assert torch.equal(y, sell_spmm_plain(sell.idx, sell.vals, x, n=N))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_sell(nb=2, nt=3):
    idx = _meta(nb, nt, 8, 128, dtype=torch.int8)
    return SellMatrix(idx, _meta(nb, nt, 8, 128), (nt * 128, nb * 128),
                      (nt * 128, nb * 128), 8, 0)


X_ERROR = re.escape("sell_spmm: x must be fp32 (B, <=384), got ")


@pytest.mark.parametrize("how", ["matrix", "direct"])
def test_wrong_width_raises_as_before(how):
    f = _meta_sell()
    x = _meta(2, 400)
    before = _counts()
    with pytest.raises(ValueError, match=X_ERROR + re.escape(
            "torch.float32 (2, 400)")):
        f.spmm(x) if how == "matrix" else sell_spmm(f.idx, f.vals, x)
    assert _delta(before) == (0, 0, 0) and not f._plans


def test_three_dimensional_x_raises_as_before():
    f = _meta_sell()
    with pytest.raises(ValueError, match=X_ERROR + re.escape(
            "torch.float32 (2, 2, 384)")):
        f.spmm(_meta(2, 2, 384))
    with pytest.raises(ValueError, match=X_ERROR + re.escape(
            "torch.float32 (1, 2, 384)")):
        f.spmv(_meta(2, 384))           # spmv of a batch
    assert not f._plans


def test_wrong_dtype_raises_as_before():
    f = _meta_sell()
    with pytest.raises(ValueError, match=X_ERROR + re.escape(
            "torch.float64 (2, 384)")):
        sell_plan(f.idx, f.vals, _meta(2, 384, dtype=torch.float64))


def test_a_matrix_off_the_card_is_refused_at_the_device_check():
    """Past the shape checks, a ``meta`` pack is refused as before: the
    plan never reaches the plain version or the library."""
    f = _meta_sell()
    with pytest.raises(ValueError, match="CUDA"):
        f.spmv(_meta(384))
    assert not f._plans


def _rebuild_share():
    """The benchmark's reader, imported by path as the benchmark does."""
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "metrics" / "plan_rebuild_share.py")
    spec = importlib.util.spec_from_file_location("plan_rebuild_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sell_program(monkeypatch, **counters):
    monkeypatch.setitem(sys.modules, "tpusparse_torch.kernels.sell_spmv",
                        types.SimpleNamespace(
                            sell_plan=types.SimpleNamespace(**counters)))


def test_plan_rebuild_share_reads_the_program_counters(monkeypatch, sell):
    read = _rebuild_share()
    sell.spmv(_x(M))
    sell.spmv(_x(M))
    assert read({}) == sell_plan.rebuilds / (sell_plan.hits
                                             + sell_plan.builds)
    _sell_program(monkeypatch, builds=16, hits=6432, rebuilds=0)
    assert read({}) == 0
    _sell_program(monkeypatch, builds=416, hits=6032, rebuilds=400)
    assert read({}) == pytest.approx(400 / 6448)


def test_plan_rebuild_share_is_none_without_the_counters(monkeypatch):
    read = _rebuild_share()
    _sell_program(monkeypatch, builds=0, hits=0, rebuilds=0)
    assert read({}) is None             # no SELL product
    _sell_program(monkeypatch, builds=16, hits=6432)
    assert read({}) is None             # a program without rebuilds
    monkeypatch.delitem(sys.modules, "tpusparse_torch.kernels.sell_spmv")
    assert read({}) is None
