"""The port's headline path as a whole, on the CPU: ``tpusparse_torch.spmv/
spmm`` over the headline registry against the JAX package's registry for
the same seed; every entry of the full registry against its JAX namesake
(512 x 384 power-law, d = 0.15, B = 1 and 4; the JAX calls, ~30 s in all
in Pallas interpret mode, most of it RSELL at B = 4, run once in a
module-scoped fixture); the CsrMatrix guard; the device rule; and the
import rule (no jax, tpusparse or ml_dtypes anywhere in the port)."""

import os
import subprocess
import sys

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch

import tpusparse_torch
from tpusparse.bench.suite import registry as jax_registry
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch.bench.suite import registry
from tpusparse_torch.config import SpmvConfig
from tpusparse_torch.testing.tester import KernelEntry, SpmvTester

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules of the router's banded and block-structured routes, of the
# training path, of the parallel layer and of the benches, the command line
# and the examples, which the import rule must reach as well
NEW_MODULES = ("formats.bsr", "formats.tcsr", "formats.dia",
               "kernels.bsr_spmv", "kernels.bsell_spmv", "kernels.dia_spmv",
               "autodiff", "nn", "prune", "graph", "kernels.sell_grad",
               "formats.ell", "formats.bell", "formats.binned",
               "kernels.bell_spmv", "kernels.sell_mxu_spmm", "bench.report",
               "bench.profile", "native", "formats.io", "entry", "reorder",
               "solve", "eig", "amg", "parallel", "parallel.mesh",
               "parallel.comm", "parallel.launch", "parallel.partition",
               "parallel.sparse", "parallel.dryrun", "bench.shard_overhead",
               "bench.scaling", "bench.commmodel", "bench.gallery",
               "bench.dynamic", "bench.scale", "cli", "__main__",
               "examples") + tuple(
    f"examples.{m[:-3]}" for m in sorted(os.listdir(os.path.join(
        os.path.dirname(tpusparse_torch.__file__), "examples")))
    if m.startswith("ex") and m.endswith(".py"))
JAX_TWIN = {"dense_torch": "dense_xla", "dense_cuda": "dense_pallas",
            "sell_cuda": "sell_pallas", "awsp_cuda": "awsp_pallas"}
FULL_TWIN = {"ell_torch": "ell_xla", "bell_cuda": "bell_pallas",
             "sell_binned_cuda": "sell_binned_pallas",
             "bsr_cuda": "bsr_pallas", "tcsr_cuda": "tcsr_pallas",
             "rsell_cuda": "rsell_pallas", "asp_cuda": "asp_pallas"}


def _full_workload(batch):
    a = jgen.random_sparse_matrix(512, 384, density=0.15, seed=0,
                                  distribution="powerlaw")
    x = jgen.random_sparse_vector(512, 0.5, seed=0) if batch == 1 else \
        jgen.random_sparse_batch(batch, 512, 0.5, seed=0)
    return a, x


@pytest.fixture(scope="module")
def jax_full():
    """Every JAX full-registry entry at B = 1 and 4: {(name, B): y}."""
    out = {}
    for batch in (1, 4):
        a, x = _full_workload(batch)
        for e in jax_registry(full=True)[4:]:
            out[e["name"], batch] = np.asarray(e["run"](e["prepare"](a), x),
                                               np.float64)
    return out


@pytest.mark.parametrize("batch", [1, 3])
def test_headline_registry_matches_jax(batch):
    m, n = 256, 384
    a = jgen.random_sparse_matrix(m, n, density=0.5, seed=0)
    x = jgen.random_sparse_vector(m, 0.5, seed=0) if batch == 1 else \
        jgen.random_sparse_batch(batch, m, 0.5, seed=0)
    y_ref = reference.sgemv_cpu(x, a) if batch == 1 else \
        reference.sgemm_cpu(x, a)
    jax_runs = {e["name"]: e for e in jax_registry(full=False)}
    entries = registry()
    assert [e["name"] for e in entries] == list(JAX_TWIN)
    xt = torch.from_numpy(x)
    for e in entries:
        je = jax_runs[JAX_TWIN[e["name"]]]
        jy = np.asarray(je["run"](je["prepare"](a), x), np.float64)
        ty = e["run"](e["prepare"](a, torch.device("cpu")), xt)
        assert ty.shape == jy.shape, e["name"]
        np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-4,
                                   err_msg=e["name"])
        np.testing.assert_allclose(ty.numpy(), y_ref, rtol=0, atol=1e-3,
                                   err_msg=e["name"])


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", list(FULL_TWIN))
def test_full_registry_matches_jax(jax_full, name, batch):
    entries = registry(full=True)
    assert [e["name"] for e in entries][4:] == list(FULL_TWIN)
    assert [e["name"] for e in jax_registry(full=True)][4:] == \
        list(FULL_TWIN.values())
    a, x = _full_workload(batch)
    e = next(e for e in entries if e["name"] == name)
    ty = e["run"](e["prepare"](a, torch.device("cpu")), torch.from_numpy(x))
    jy = jax_full[FULL_TWIN[name], batch]
    assert ty.shape == jy.shape, name
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-4)
    y_ref = reference.sgemv_cpu(x, a) if batch == 1 else \
        reference.sgemm_cpu(x, a)
    np.testing.assert_allclose(ty.numpy(), y_ref, rtol=0, atol=1e-3)


def test_public_spmv_spmm_on_cpu():
    a = jgen.random_sparse_matrix(200, 300, density=0.5, seed=1)
    x = jgen.random_sparse_vector(200, 0.5, seed=1)
    xb = jgen.random_sparse_batch(2, 200, 0.5, seed=1)
    y, yb = reference.sgemv_cpu(x, a), reference.sgemm_cpu(xb, a)
    fmts = [tpusparse_torch.SellMatrix.from_dense(a, device="cpu"),
            tpusparse_torch.AwspMatrix.from_dense(a, device="cpu"),
            torch.from_numpy(a)]
    for f in fmts:
        np.testing.assert_allclose(tpusparse_torch.spmv(f, x), y, atol=1e-3)
        np.testing.assert_allclose(tpusparse_torch.spmm(f, xb), yb, atol=1e-3)
    np.testing.assert_allclose(tpusparse_torch.spmv(a, x, device="cpu"), y,
                               atol=1e-3)
    assert tpusparse_torch.spmv(fmts[0], torch.from_numpy(x)).shape == (300,)


def test_tester_runs_headline_registry_on_cpu():
    t = SpmvTester(SpmvConfig(m=256, n=256, batch=2), device="cpu")
    for e in registry():
        t.register(KernelEntry(e["name"], e["prepare"], e["run"]))
    reps = t.run(verbose=False)
    assert [r.name for r in reps] == list(JAX_TWIN) and all(r.ok for r in reps)


def test_csr_is_rejected():
    csr = tpusparse_torch.CsrMatrix.from_dense(
        jgen.random_sparse_matrix(128, 128, density=0.5, seed=2))
    with pytest.raises(TypeError, match="interchange"):
        tpusparse_torch.spmv(csr, np.zeros(128, np.float32))
    with pytest.raises(TypeError, match="interchange"):
        tpusparse_torch.spmm(csr, np.zeros((2, 128), np.float32))


def test_device_none_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = jgen.random_sparse_matrix(128, 128, density=0.5, seed=3)
    for make in (lambda: tpusparse_torch.SellMatrix.from_dense(a),
                 lambda: tpusparse_torch.AwspMatrix.from_dense(a),
                 lambda: tpusparse_torch.spmv(a, np.zeros(128, np.float32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_port_imports_no_jax():
    code = (
        f"NEW = {NEW_MODULES!r}\n"
        "import importlib, pkgutil, sys\n"
        "import chip_smoke, tpusparse_torch\n"
        "for m in pkgutil.walk_packages(tpusparse_torch.__path__,"
        " 'tpusparse_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'tpusparse', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "want = {'tpusparse_torch.' + m for m in NEW}\n"
        "assert want <= set(sys.modules), want - set(sys.modules)\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
