"""Each cell's check against its control and its faults, on the CPU at a
small size: the harness's look for a card is skipped and the rest of a run
is driven as it is on the card. The program as it is comes out correct;
the lower-precision control, and the program broken underneath the timed
path, come out not correct."""

import json

import pytest
import torch

from benchmarks import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
SMALL = {
    "sgemv4096": ({"m": 512, "n": 512, "layers": 2}, {"pool": 4}),
    "hpcg27": ({}, {"grid": [16, 16, 16], "pool": 2}),
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(cell, system=None, seed=2 ** 31 + 11, trace=False):
    config = next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    cfg_over, traffic_over = SMALL[config]
    torch.set_num_threads(2)
    return harness.run_cell(BENCH, cell, seed, 0.2, trace, CPU,
                            system=system, cfg_over=cfg_over,
                            traffic_over={**traffic_over, "trace_steps": 2})


def _program(cell):
    config = next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    cfg = harness.load_json("configs", config)
    return config, cfg, harness.load_module("configs", config).Program(cfg)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_program_is_correct(cell, trace):
    line = _run(cell, trace=trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    config, cfg, _ = _program(cell)
    control = harness.load_module("reference", config).Control(cfg)
    line = _run(cell, system=control)
    assert not line["correct"]


def _faults(cell):
    config, cfg, prog = _program(cell)
    out = {}
    if config == "sgemv4096":
        class Unchanged(type(prog)):
            def product(self, p, x):
                return torch.zeros(x.shape[:-1] + (p.shape[1],))

        class Altered(type(prog)):
            def product(self, p, x):
                y = super().product(p, x)
                y.view(-1)[0] += 1.0
                return y

        class HalfBatch(type(prog)):
            def product(self, p, x):
                if x.ndim == 1:
                    return super().product(p, x)
                h = x.shape[0] // 2
                y = super().product(p, x[:h])
                return torch.cat([y, torch.zeros_like(y)])

        out = {"unchanged": Unchanged(cfg), "altered": Altered(cfg)}
        traffic = next(w["traffic"] for w in BENCH["workloads"]
                       if w["name"] == cell)
        if harness.load_json("traffic", traffic)["batch"] > 1:
            out["half_batch"] = HalfBatch(cfg)
    else:
        class Unchanged(type(prog)):
            def solve(self, op, b, tol, maxiter, apply_=None):
                return torch.zeros_like(b), 1

        class Altered(type(prog)):
            def solve(self, op, b, tol, maxiter, apply_=None):
                x, k = super().solve(op, b, tol, maxiter, apply_)
                x[0] += 1.0
                return x, k

        out = {"unchanged": Unchanged(cfg), "altered": Altered(cfg)}
    return out


FAULTS = [(c, f) for c in CELLS for f in _faults(c)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault):
    line = _run(cell, system=_faults(cell)[fault])
    assert not line["correct"]
