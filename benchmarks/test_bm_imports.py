"""Nothing the benchmark runs may load JAX or the JAX package, and the
plain references load nothing of the program either; each module is
compared by its whole top-level name (``tpusparse_torch`` begins with
``tpusparse``)."""

import ast
import json
import subprocess
import sys
import types

import pytest

from benchmarks import harness

REFERENCES = sorted((harness.HERE / "reference").glob("*.py")) + \
    [harness.HERE / "plain.py"]
NOT_IN_REFERENCE = {"jax", "jaxlib", "flax", "tpusparse", "tpusparse_torch"}


def _top_level_imports(path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_level_imports(path) & NOT_IN_REFERENCE


def test_loaded_references_hold_no_program_module():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "before = {k.split('.')[0] for k in sys.modules}\n"
        "from benchmarks import harness\n"
        "for n in %r: harness.load_module('reference', n)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules}"
        " - before)))" % (str(harness.ROOT),
                          [p.stem for p in REFERENCES if p.name != "plain.py"]))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert not loaded & NOT_IN_REFERENCE


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusparse_torch_like",
                        types.ModuleType("tpusparse_torch_like"))
    assert "tpusparse" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpusparse.formats",
                        types.ModuleType("tpusparse.formats"))
    assert "tpusparse" in harness.forbidden_modules()


def test_drivers_load_no_jax():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmarks import harness\n"
        "for n in %r: harness.load_module('configs', n)\n"
        "print(json.dumps(harness.forbidden_modules()))"
        % (str(harness.ROOT),
           [c["name"] for c in json.loads(
               (harness.ROOT / "BENCHMARK.json").read_text())["configs"]]))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=300)
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_refuses_to_time_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    rc = harness.main(["--workload", "sgemv4096.stack-b1", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
