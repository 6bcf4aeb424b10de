"""The port's command line (``python -m tpusparse_torch``) on the CPU: every
JAX subcommand but ``tune``; ``check`` over the full registry; ``mtx`` on
the repo's FEM mesh, routed as the JAX package routes it; ``solve`` with
each preconditioner; the timing commands refuse ``--cpu``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from tpusparse_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "data", "fem_mesh_16384.mtx")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the host's cores, and
    each worker's own thread pool would oversubscribe them (the examples'
    training loops slowed some 100 x that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_help_lists_every_jax_subcommand_but_tune():
    import re

    src = open(os.path.join(ROOT, "tpusparse", "cli.py")).read()
    jax_cmds = set(re.findall(r'\("(\w+)", cmd_\w+\)', src)) | \
        set(re.findall(r'"(\w+)": cmd_\w+', src))
    assert "tune" in jax_cmds and len(jax_cmds) == 12
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-m", "tpusparse_torch", "--help"],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    listed = set(re.search(r"\{([\w,]+)\}", out.stdout).group(1).split(","))
    assert listed == jax_cmds - {"tune"}


def test_check_cpu_runs_the_full_registry(capsys):
    from tpusparse_torch.bench.suite import registry

    assert cli.main(["check", "--cpu", "--m", "512", "--n", "512"]) == 0
    out = capsys.readouterr().out
    for e in registry(full=True):
        assert f"[{e['name']}]" in out
    assert out.count(" OK") == len(registry(full=True))


def test_mtx_routes_as_jax(capsys):
    from tpusparse.formats.auto import matrix_stats_csr, route
    from tpusparse.formats.csr import CsrMatrix

    assert cli.main(["mtx", MESH, "--cpu", "--no-time"]) == 0
    out = capsys.readouterr().out
    csr = CsrMatrix.from_mtx(MESH)
    want = route(*csr.shape, matrix_stats_csr(csr))
    assert f"route: {want}\n" in out
    assert "(OK)" in out


@pytest.mark.parametrize("precond", ["none", "jacobi", "chebyshev", "amg"])
def test_solve_cpu(precond, capsys):
    assert cli.main(["solve", "--side", "24", "--precond", precond,
                     "--cpu"]) == 0
    assert "[OK]" in capsys.readouterr().out


def test_solve_file_amg_cpu(capsys):
    assert cli.main(["solve", "--file", MESH, "--precond", "amg",
                     "--cpu"]) == 0
    assert "[OK]" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["bench", "headline", "profile", "report"])
def test_timing_commands_refuse_the_cpu(cmd):
    assert cli.main([cmd, "--cpu"]) == 2


def test_scaling_model_and_forwarded_benches(capsys):
    assert cli.main(["scaling", "--model", "--m", "512", "--n", "512"]) == 0
    assert cli.main(["gallery", "--list"]) == 0
    assert "stencil2d-64" in capsys.readouterr().out
