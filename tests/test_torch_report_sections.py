"""The port's report sections (``tpusparse_torch.bench.report``) build the
JAX report's workloads, on the CPU.

Each JAX section runs with its timing, packing and solver calls replaced
by recorders (nothing is packed, multiplied or timed), so the arrays it
would have timed are captured: its A and X bit for bit against the port's
``section_inputs``, and its registry entries (mapped to the port's names)
against the port's. ``verify_docs`` passes on the repo and finds a
missing citation and an artifact share.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from tpusparse_torch.bench import report as pr


class _Fmt:
    """Stands in for a JAX pack: what the sections read of one."""

    w = 8
    vals = np.zeros(1, np.float32)
    idx = vals

    def __init__(self, *a, **kw):
        self.args = a

    def plan(self, x):
        return np.zeros(1, np.int32)

    def device_bytes(self, *a):
        return 1

    def spmv(self, x):
        return np.zeros(pr.SIZE, np.float32)


def _timing(calls):
    def record(fn, *args, **kw):
        calls.append(args)
        return types.SimpleNamespace(seconds=1.0, gbps=1.0, nnz_per_s=1.0,
                                     name=kw.get("name", ""), bytes_moved=1)
    return record


@pytest.fixture
def jax_report(monkeypatch):
    """The JAX report module with its timing and packing recorded."""
    import tpusparse.autodiff
    import tpusparse.bench.runner
    import tpusparse.formats.auto
    from tpusparse.bench import report as jr
    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.formats.bsr import BsrMatrix
    from tpusparse.formats.rsell import RsellMatrix
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.formats.tcsr import TcsrMatrix

    calls, entries = [], []
    monkeypatch.setattr(jr, "device_time", _timing(calls))
    monkeypatch.setattr(tpusparse.bench.runner, "chain_device_time",
                        _timing(calls))
    monkeypatch.setattr(jr, "format_bytes", lambda f: 1)
    monkeypatch.setattr(jr, "detect_hbm_gbps", lambda: 1.0)
    monkeypatch.setattr(jr, "_row", lambda *a: "")
    monkeypatch.setattr(jr, "_bench_entries",
                        lambda a, x, ents, out: entries.append(
                            (a, x, [e["name"] for e in ents])))
    for cls in (SellMatrix, AwspMatrix, BsrMatrix, RsellMatrix, TcsrMatrix):
        monkeypatch.setattr(cls, "from_dense",
                            classmethod(lambda c, *a, **k: _Fmt(*a)))
    seen = {}

    def trainable(csr):
        seen["train_csr"] = csr
        return (lambda p, x: 0.0), {"vals": np.zeros(2, np.float32)}, {}, None

    def auto(a, **kw):
        seen["auto"] = a
        return np.zeros(1, np.float32)

    monkeypatch.setattr(tpusparse.autodiff, "trainable_linear", trainable)
    monkeypatch.setattr(tpusparse.formats.auto, "auto_format", auto)
    return jr, calls, entries, seen


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", ["canonical", "powerlaw", "lowdensity",
                                  "spmm"])
def test_entry_sections_match_jax(name, jax_report):
    import io

    jr, _, entries, _ = jax_report
    getattr(jr, f"_{name}")(io.StringIO())
    (a, x, names), = entries
    w = pr.section_inputs(name)
    _same(w["a"], a)
    _same(w["x"], x)
    assert w["entries"] == [pr.REGISTRY_NAMES[k] for k in names]


@pytest.mark.parametrize("name", ["structured", "tcsr"])
def test_format_sections_match_jax(name, jax_report):
    import io

    jr, calls, _, _ = jax_report
    getattr(jr, f"_{name}")(io.StringIO())
    w = pr.section_inputs(name)
    a, x = calls[0]                  # the dense baseline's (A, X) first
    _same(w["a"], a)
    _same(w["x"], x)
    assert all(np.array_equal(np.asarray(c[-1]), w["x"]) for c in calls)


def test_reduced_crossover_floors_match_jax(jax_report):
    import io

    jr, calls, _, _ = jax_report
    jr._reduced(io.StringIO())
    w = pr.section_inputs("reduced")
    assert len(calls) == len(w["dtypes"]) == 3
    assert all(np.array_equal(c[-1], w["x"]) for c in calls)
    calls.clear()
    jr._crossover(io.StringIO())
    w = pr.section_inputs("crossover")
    dense = [c[0] for c in calls[::2]]
    assert len(dense) == len(w["densities"])
    for d, a in zip(w["densities"], dense):
        _same(w["a_of"](d), a)
    calls.clear()
    jr._floors(io.StringIO())
    w = pr.section_inputs("floors")
    xs = [c[-1] for c in calls[2::3]]           # dense_xla's (A, X_B)
    want = [(d, b) for d in w["densities"] for b in w["batches"]]
    assert len(xs) == len(want)
    for (d, b), got, c in zip(want, xs, calls[2::3]):
        _same(w["x_of"](b), got)
        _same(w["a_of"](d), c[0])


def test_training_and_solver_match_jax(jax_report):
    import io

    jr, calls, _, seen = jax_report
    jr._training(io.StringIO())
    w = pr.section_inputs("training")
    from tpusparse.formats.csr import CsrMatrix

    want = CsrMatrix.from_dense(w["a"])
    for field in ("row_ptr", "col_idx", "values"):
        _same(getattr(seen["train_csr"], field), getattr(want, field))
    _same(calls[0][-1], w["x"])
    calls.clear()
    jr._solver(io.StringIO(), side=64)
    got = pr.laplacian_2d(64)
    lap = seen["auto"]
    for field in ("row_ptr", "col_idx", "values"):
        _same(getattr(got, field), getattr(lap, field))
    assert pr.SOLVER_SIDE == 1024 and pr.SOLVER_ITERS == (16, 272)
    _same(calls[0][-1], np.random.default_rng(0).normal(size=64 * 64)
          .astype(np.float32))
    assert pr.section_inputs("solver")["b"].shape == (1024 ** 2,)


def test_sections_are_the_jax_report_s():
    import inspect

    from tpusparse.bench import report as jr

    src = inspect.getsource(jr.main)
    order = [s for s in pr.SECTIONS if f'on("{s}")' in src]
    assert order == list(pr.SECTIONS)
    assert sorted(src.index(f'on("{s}")') for s in order) == \
        [src.index(f'on("{s}")') for s in order]


def test_verify_docs_clean_on_the_repo():
    assert pr.verify_docs() == []


def test_verify_docs_finds_missing_files_and_artifacts(tmp_path):
    (tmp_path / "PERF.md").write_text("see `tpusparse_torch/no_such.py:3` "
                                      "and `chip_smoke.py`\n")
    (tmp_path / "chip_smoke.py").write_text("")
    rec = tmp_path / "rec.json"
    rec.write_text(json.dumps({"rows": [{"roofline": 1.2},
                                        {"share": 0.9}]}))
    problems = pr.verify_docs(str(tmp_path), records=(str(rec),))
    assert len(problems) == 2
    assert "no_such.py" in problems[0] and "1.2" in problems[1]


def test_verify_docs_leaves_documents_to_their_checkout(tmp_path):
    # a checkout of the code alone: the README's port section cites
    # PERF.md, which that checkout does not carry
    (tmp_path / "README.md").write_text(
        "# tpusparse_torch\n\nsee `PERF.md` and `chip_smoke.py`\n")
    assert pr.verify_docs(str(tmp_path)) == [
        "README.md cites chip_smoke.py, which does not exist"]
    (tmp_path / "chip_smoke.py").write_text("")
    assert pr.verify_docs(str(tmp_path)) == []
