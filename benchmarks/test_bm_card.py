"""Every cell end to end on the card at a small size; skips without one.
Run on the card: python -m pytest benchmarks -m gpu"""

import json

import pytest
import torch

from benchmarks import harness
from benchmarks.test_bm_faults import SMALL

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = next(w["config"] for w in BENCH["workloads"]
                  if w["name"] == cell)
    cfg_over, traffic_over = SMALL[config]
    line = harness.run_cell(BENCH, cell, 2 ** 31 + 3, 0.5, trace,
                            torch.device("cuda", 0), cfg_over=cfg_over,
                            traffic_over=traffic_over)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
