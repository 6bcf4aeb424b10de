"""BENCHMARK.json against the contract it is written to, and every file it
names found by name."""

import json
import math
import re

import pytest

from benchmarks import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and LINE.match(c["why"])
    assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
    assert c["file"] == f"benchmarks/configs/{c['name']}.json"
    cfg = harness.load_json("configs", c["name"])
    assert cfg["name"] == c["name"]
    assert all(k in cfg for k in c["reduced"])
    assert (harness.HERE / "configs" / f"{c['name']}.py").exists()
    assert (harness.HERE / "reference" / f"{c['name']}.py").exists()
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert LINE.match(w["why"]) and w["chips"] == 1
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = harness.load_json("traffic", w["traffic"])
    assert traffic["sample"] >= 1 and traffic["trace_steps"] >= 1
    e2e = [m for m in BENCH["end_to_end"] if harness.applies(m, w["name"])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(harness.applies(m, w["name"]) for m in BENCH["per_layer"])


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES_E2E
    assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert LINE.match(m["layer"])
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in m.get("workloads", cells):
        assert cell in cells and harness.applies(moved, cell)
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"
    assert callable(harness.load_module("metrics", m["name"]).read)


def test_run_seconds_fit_the_check_with_24_cells():
    runs = 2 + 14 * 24
    budget = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert budget <= 43200 and not math.isnan(budget)


def test_setup_counts_from_process_start():
    import subprocess
    import sys

    # a fresh interpreter that sleeps before it reads its own start: the
    # reading has to reach back past the sleep
    code = ("import time; time.sleep(0.5); import sys; "
            f"sys.path.insert(0, {str(harness.HERE)!r}); import run; "
            "print(time.perf_counter() - run.process_start())")
    age = float(subprocess.run([sys.executable, "-c", code], check=True,
                               capture_output=True, text=True).stdout)
    assert 0.5 <= age < 60
