"""The port's router against the JAX package's: ``matrix_stats`` and
``matrix_stats_csr`` give the same dicts, ``route`` the same string for
every case of the JAX router tests at B = 1, 4 and 8, ``predicted_bytes``
the same bytes; ``auto_format`` packs every kind into the port's classes
(whose products meet the oracle on the CPU), binned SELL included, so no
kind is left to refuse; every entry of the full bench registry meets the
oracle.
"""

import numpy as np
import pytest
import torch

from tpusparse.formats.auto import matrix_stats as jstats
from tpusparse.formats.auto import matrix_stats_csr as jstats_csr
from tpusparse.formats.auto import predicted_bytes as jpredicted
from tpusparse.formats.auto import route as jroute
from tpusparse.formats.auto import sorted_slot_tile_bytes as jsorted_bytes
from tpusparse.formats.binned import BinnedSellMatrix as JBinned
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
import tpusparse_torch
from tpusparse_torch.bench.suite import registry
from tpusparse_torch.formats import CsrMatrix
from tpusparse_torch.formats.auto import (NOT_PORTED, matrix_stats,
                                          matrix_stats_csr, predicted_bytes,
                                          route, sorted_slot_tile_bytes)

# the matrices of the JAX package's router tests, plus banded ones (DIA),
# with the kind each routes to at B = 1 (unstructured X)
CASES = {
    "uniform_mid": ((512, 384, 0.4, "uniform", 1), "sell"),
    "near_dense": ((512, 384, 0.8, "uniform", 1), "asp"),
    "blocks": ((512, 384, 0.3, "blocks", 2), "tcsr"),
    "powerlaw": ((1024, 512, 0.15, "powerlaw", 4), "rsell"),
    "stats_shape": ((300, 200, 0.3, "uniform", 6), "sell"),
    "batched_mid": ((512, 384, 0.5, "uniform", 7), "sell"),
    "batched_low": ((512, 384, 0.1, "uniform", 10), "rsell"),
    "near_dense_small": ((256, 256, 0.9, "uniform", 7), "asp"),
    "banded": ((512, 512, 0.05, "banded", 3), "dia"),
    "thin_wide": ((256, 2048, 0.01, "uniform", 6), "rsell"),
    "hypersparse": ((640, 640, 0.002, "uniform", 3), "rsell"),
}
# skew stats of a 65536^2 matrix (the JAX test of the budget fallback)
BIG_SKEW = dict(density=1e-5, nnz=200, empty_block_frac=0.0, w_global=12,
                w_typical=8.0, slot_tile_bytes=1000)


def _matrix(name):
    m, n, d, dist, seed = CASES[name][0]
    return jgen.random_sparse_matrix(m, n, density=d, seed=seed,
                                     distribution=dist)


def _csrs(a):
    jc = JCsr.from_dense(a, use_native=False)
    return CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values), jc


@pytest.mark.parametrize("name", list(CASES))
def test_stats_and_route_match_jax(name):
    a = _matrix(name)
    m, n = a.shape
    s = matrix_stats(a)
    assert s == jstats(a)
    assert matrix_stats(torch.from_numpy(a)) == s
    tc, jc = _csrs(a)
    sc = matrix_stats_csr(tc)
    assert sc == jstats_csr(jc)
    for stats in (s, sc):
        for batch in (1, 4, 8):
            for structured in (False, True):
                kw = dict(expect_batch=batch, expect_structured_x=structured)
                assert route(m, n, stats, **kw) == jroute(m, n, stats, **kw)
    assert route(m, n, s) == CASES[name][1]


def test_route_matches_jax_on_drawn_stats():
    """Statistics drawn across every branch's thresholds, including the
    RSELL budget fallback at 65536^2."""
    rng = np.random.default_rng(0)
    for _ in range(400):
        m, n = (int(v) for v in rng.choice([128, 300, 4096, 65536, 262144],
                                           2))
        nnz = int(rng.integers(0, m * n // 2 + 1))
        s = dict(density=nnz / (m * n), nnz=nnz,
                 empty_block_frac=float(rng.choice([0.0, 0.3, 0.5])),
                 w_global=int(rng.integers(0, 200)),
                 w_typical=float(rng.choice([0.0, 4.0, 40.0])),
                 n_diags=int(rng.choice([3, 100, 600])),
                 diag_sym=bool(rng.integers(2)),
                 slot_tile_bytes=int(rng.integers(0, 5 * m * n)))
        for batch in (1, 4, 8, 48):
            assert route(m, n, s, expect_batch=batch) == \
                jroute(m, n, s, expect_batch=batch), (m, n, s, batch)
    assert [route(65536, 65536, BIG_SKEW, expect_batch=b)
            for b in (4, 48)] == ["rsell", "binned"]


@pytest.mark.parametrize("name", ["powerlaw", "batched_low", "banded",
                                  "blocks"])
def test_predicted_bytes_match_jax(name):
    a = _matrix(name)
    m, n = a.shape
    s = matrix_stats(a)
    tc, jc = _csrs(a)
    assert sorted_slot_tile_bytes(tc) == jsorted_bytes(jc)
    for kind in ("dia", "asp", "tcsr", "rsell", "binned", "sell", "awsp"):
        assert predicted_bytes(m, n, s, kind) == jpredicted(m, n, s, kind)
        assert predicted_bytes(m, n, s, kind, csr=tc) == \
            jpredicted(m, n, s, kind, csr=jc)


@pytest.mark.parametrize("name,batch,structured,cls", [
    ("uniform_mid", 1, False, "SellMatrix"),
    ("uniform_mid", 1, True, "AwspMatrix"),
    ("powerlaw", 1, False, "RsellMatrix"),
    ("thin_wide", 1, False, "RsellMatrix"),
    ("batched_mid", 8, False, "AspMatrix"),
    ("near_dense", 1, False, "AspMatrix"),
    ("banded", 1, False, "DiaMatrix"),
    ("blocks", 1, False, "TcsrMatrix"),
    ("blocks", 8, False, "TcsrMatrix"),
])
def test_auto_format_packs_port_classes(name, batch, structured, cls):
    a = _matrix(name)
    kw = dict(expect_batch=batch, expect_structured_x=structured)
    f = tpusparse_torch.auto_format(a, device="cpu", **kw)
    assert type(f).__name__ == cls
    tc, _ = _csrs(a)
    assert type(tpusparse_torch.auto_format(tc, device="cpu", **kw)) is \
        type(f)
    x = jgen.random_sparse_batch(batch, a.shape[0], 0.5, seed=3) \
        if batch > 1 else jgen.random_sparse_vector(a.shape[0], 0.5, seed=3)
    y = tpusparse_torch.spmm(f, x) if batch > 1 else tpusparse_torch.spmv(f, x)
    want = reference.sgemm_cpu(x, a) if batch > 1 \
        else reference.sgemv_cpu(x, a)
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-3)


def test_auto_format_refuses_kinds_not_ported():
    """No kind is left to refuse: the one the router could not pack before
    (binned SELL, on the JAX router test's skewed 65536^2 CSR at B = 48,
    where RSELL's budget no longer fits) now packs as ``BinnedSellMatrix``,
    the same pack as the JAX package's. (Its 1.3 GB of mostly untouched
    zero slots are compared, not multiplied: the products of binned SELL
    are held to the oracle in tests/test_torch_binned.py.)"""
    assert NOT_PORTED == {}
    rng = np.random.default_rng(0)
    n = 65536
    rows = np.sort(rng.integers(0, n, 200))
    csr = CsrMatrix.from_coo(n, n, rows, rng.integers(0, n, 200),
                             rng.uniform(-1, 1, 200).astype(np.float32))
    assert route(n, n, BIG_SKEW, expect_batch=48) == "binned"
    f = tpusparse_torch.auto_format(csr, expect_batch=48, stats=BIG_SKEW,
                                    device="cpu")
    assert type(f).__name__ == "BinnedSellMatrix"
    jf = JBinned.from_csr(JCsr(csr.shape, csr.row_ptr, csr.col_idx,
                               csr.values))
    assert f.widths == jf.widths and f.nnz == jf.nnz == 200
    assert np.array_equal(f.inv_perm, np.asarray(jf.inv_perm))
    for b, jb in zip(f.buckets, jf.buckets, strict=True):
        assert np.array_equal(b["idx"].numpy(), np.asarray(jb["idx"]))
        assert np.array_equal(b["vals"].numpy(), np.asarray(jb["vals"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpusparse_torch.auto_format(_matrix("powerlaw"))


FULL_ONLY = ["ell_torch", "bell_cuda", "sell_binned_cuda", "bsr_cuda",
             "tcsr_cuda", "rsell_cuda", "asp_cuda"]


@pytest.mark.parametrize("name", FULL_ONLY)
def test_full_registry_adds_rsell_and_asp(name):
    """The full registry is the headline set plus the JAX full list in its
    order, and each full entry meets the oracle on the CPU."""
    entries = registry(full=True)
    assert [e["name"] for e in entries][4:] == FULL_ONLY
    assert [e["name"] for e in entries][:4] == \
        [e["name"] for e in registry()]
    e = next(e for e in entries if e["name"] == name)
    a = _matrix("powerlaw")
    x = torch.from_numpy(jgen.random_sparse_batch(2, 1024, 0.5, seed=9))
    y = e["run"](e["prepare"](a, torch.device("cpu")), x)
    np.testing.assert_allclose(y.numpy(), reference.sgemm_cpu(x.numpy(), a),
                               rtol=0, atol=1e-3, err_msg=name)
