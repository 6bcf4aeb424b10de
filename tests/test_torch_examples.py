"""The port's examples (``tpusparse_torch/examples``) on the CPU: each
``main(device="cpu")`` runs its own checks (it raises on a failure) and
returns its numbers; 03 and 05 also on two gloo ranks.
"""

from __future__ import annotations

import importlib
import pkgutil

import pytest
import torch

import tpusparse_torch.examples as examples

MODULES = sorted(m.name for m in pkgutil.iter_modules(examples.__path__))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the host's cores, and
    each worker's own thread pool would oversubscribe them (the examples'
    training loops slowed some 100 x that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_thirteen_examples():
    assert [m[:4] for m in MODULES] == [f"ex{i:02d}" for i in range(1, 14)]


# the GCN's plain dense-tile products take seconds a step on one CPU
# thread: its loss is checked after 3 of its 60 steps
SHORT = {"ex12_gcn_node_classification": dict(steps=3)}


@pytest.mark.parametrize("name", MODULES)
def test_example_cpu(name):
    out = importlib.import_module(f"tpusparse_torch.examples.{name}") \
        .main(device="cpu", **SHORT.get(name, {}))
    assert isinstance(out, dict) and out


@pytest.mark.parametrize("name", [m for m in MODULES
                                  if m.startswith(("ex03", "ex05"))])
def test_multi_rank_example_on_two_gloo_ranks(name):
    out = importlib.import_module(f"tpusparse_torch.examples.{name}") \
        .main(device="cpu", world=2)
    assert out["world"] == 2
