"""The reader of the program's own counter on a hand-made record and a
hand-made program module: it returns the counter, and None when the
program keeps no such counter (a program older than it) or the run never
loaded the module."""

import sys
import types

import pytest

from benchmarks import harness

REC = {"spans": {"pass": {"count": 2, "cpu_s": 0.004, "device_s": 0.001}},
       "counters": {"products": 32, "pack_s": 8.0}}


def _program(monkeypatch, **counters):
    monkeypatch.setitem(sys.modules, "tpusparse_torch.formats.auto",
                        types.SimpleNamespace(
                            auto_format=types.SimpleNamespace(**counters)))


def test_stats_s_reads_the_program_counter(monkeypatch):
    _program(monkeypatch, stats_s=5.5)
    read = harness.load_module("metrics", "stats_s").read
    assert read(REC) == pytest.approx(5.5)


def test_stats_s_is_none_without_the_counter(monkeypatch):
    read = harness.load_module("metrics", "stats_s").read
    _program(monkeypatch)
    assert read(REC) is None
    monkeypatch.delitem(sys.modules, "tpusparse_torch.formats.auto")
    assert read(REC) is None
