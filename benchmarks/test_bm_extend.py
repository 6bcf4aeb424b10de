"""A cell, a configuration, a traffic mix and a per-layer metric are added
with new files and new entries in BENCHMARK.json alone: no harness file
changes. Done here in a copy of this folder."""

import copy
import json
import shutil

import torch

from benchmarks import harness

DRIVER = '''
import torch
from benchmarks.harness import Sampler, load_module

ref = load_module("reference", "dummy")


class Run:
    spans = ("request", "double")

    def __init__(self, cfg, traffic, seed, device, system=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.x = ref.inputs(seed, traffic["size"], device)
        self.route = "torch"
        self.phases = {}
        self.traced = False
        self.reset()

    def reset(self):
        self.sampler = Sampler(self.traffic["sample"], self.seed)
        self.kept, self.steps = {}, 0

    attempted = property(lambda self: self.steps)

    def step(self, i):
        with torch.profiler.record_function("double"):
            y = self.x * 2
        slot = self.sampler.offer(i)
        if slot is not None:
            self.kept[slot] = y
        self.steps += 1

    def counters(self):
        return {"steps": self.steps}

    def end_to_end(self, loop):
        return {"steps_per_s": self.steps / loop["elapsed_s"]}

    def release(self):
        self.x = None

    def check(self):
        want = 2 * ref.inputs(self.seed, self.traffic["size"], "cpu")
        worst = max(float((y - want).abs().max()) for y in self.kept.values())
        return {"gap": (worst, self.cfg["limits"]["gap"])}, 0
'''
REFERENCE = '''
import torch


def inputs(seed, size, device):
    return torch.arange(size, dtype=torch.float32, device=device) + seed
'''
METRIC = '''
def read(rec):
    return float(rec["counters"]["steps"])
'''


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    here = root / "benchmarks"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "configs" / "dummy.json").write_text(
        json.dumps({"name": "dummy", "limits": {"gap": 0.0}}))
    (here / "configs" / "dummy.py").write_text(DRIVER)
    (here / "reference" / "dummy.py").write_text(REFERENCE)
    (here / "traffic" / "once.json").write_text(
        json.dumps({"size": 16, "sample": 2, "trace_steps": 3}))
    (here / "metrics" / "dummy_steps.py").write_text(METRIC)
    bench = copy.deepcopy(json.loads(
        (harness.ROOT / "BENCHMARK.json").read_text()))
    bench["configs"].append({"name": "dummy", "source": "none",
                             "file": "benchmarks/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.once", "config": "dummy",
                               "traffic": "once", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "steps_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy.once"]})
    bench["per_layer"].append({"name": "dummy_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "steps_per_s",
                               "workloads": ["dummy.once"]})
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", root)
    cpu = torch.device("cpu")
    line = harness.run_cell(bench, "dummy.once", 3, 0.05, False, cpu)
    assert line["correct"] and set(line["metrics"]) == {"steps_per_s",
                                                        "setup_s"}
    line = harness.run_cell(bench, "dummy.once", 3, 0.05, True, cpu)
    assert line["correct"]
    assert line["metrics"] == {"dummy_steps": {"value": 3.0,
                                               "unit": "steps"}}
