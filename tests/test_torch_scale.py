"""The port's GB-scale run (``tpusparse_torch.bench.scale``) at a small
``--m`` on the CPU, against the JAX package's generator, statistics,
route and byte prediction; its cliff and train gates under a caller's
budget; its record file only when asked for.
"""

from __future__ import annotations

import json

import pytest

from tpusparse_torch.bench import scale

M, D, SEED = 2048, 0.02, 42


@pytest.fixture(scope="module")
def jax_ref():
    from tpusparse.formats.auto import (matrix_stats_csr, predicted_bytes,
                                        route)
    from tpusparse.testing import generators

    csr = generators.random_sparse_csr(M, M, D, seed=SEED,
                                       distribution="powerlaw")
    s = matrix_stats_csr(csr)
    kind = route(M, M, s)
    return dict(nnz=csr.nnz, routed=kind,
                predicted=predicted_bytes(M, M, s, kind, csr=csr))


@pytest.fixture(scope="module")
def full_run():
    return scale.run(m=M, density=D, seed=SEED, device="cpu", verbose=False)


def test_scale_matches_jax(full_run, jax_ref):
    rec = full_run
    assert rec["nnz"] == jax_ref["nnz"]
    assert rec["routed"] == jax_ref["routed"]
    assert rec["predicted_gb"] * 1e9 == pytest.approx(jax_ref["predicted"],
                                                      rel=1e-12)
    assert rec["format"] == "RsellMatrix"
    assert rec["max_abs_err"] <= 1e-3
    assert rec["budget_gb"] is None and rec["budget_from"] == "none"
    assert "cliff" not in rec and "train_gate" not in rec
    assert "spmv_us" not in rec and "train_us" not in rec   # no CPU times
    assert rec["train_operands_gb"] > rec["format_gb"]


def test_train_step_held_to_the_oracle(full_run):
    assert full_run["train_y_err"] <= 1e-5
    assert full_run["train_grad_err"] <= 1e-5


def test_wrong_value_gradient_fails_the_run(monkeypatch):
    """The sampled gradient check catches value gradients 1% off."""
    from tpusparse_torch import autodiff

    real = autodiff.sell_dvals
    monkeypatch.setattr(autodiff, "sell_dvals",
                        lambda s, x, g: real(s, x, g) * 1.01)
    with pytest.raises(AssertionError, match="train_grad_err"):
        scale.run(m=1024, density=D, seed=SEED, device="cpu", verbose=False)


def test_cliff_under_a_small_budget(jax_ref):
    rec = scale.run(m=M, density=D, seed=SEED, device="cpu", verbose=False,
                    budget=int(jax_ref["predicted"]) - 1)
    assert rec["cliff"] == "quantum_floor"
    assert rec["budget_from"] == "caller"
    assert "budget" in rec["floor_law"] and "pack_s" not in rec


def test_train_gate_names_its_budget(full_run):
    budget = int(full_run["train_operands_gb"] * 1e9) - 1
    rec = scale.run(m=M, density=D, seed=SEED, device="cpu", verbose=False,
                    budget=budget)
    assert "cliff" not in rec and rec["max_abs_err"] <= 1e-3
    assert "trainable_linear_sharded" in rec["train_gate"]
    assert rec["budget_gb"] == budget / 1e9
    assert "twin_pack_s" not in rec        # gated before packing


def test_main_writes_only_when_asked(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--m", "1024", "--density", "0.02", "--cpu", "--no-train"]
    assert scale.main(argv) == 0
    assert list(tmp_path.iterdir()) == []
    path = tmp_path / "scale.json"
    assert scale.main(argv + ["--json", str(path)]) == 0
    recs = json.loads(path.read_text())
    assert len(recs) == 1 and recs[0]["m"] == 1024
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["m"] == 1024
