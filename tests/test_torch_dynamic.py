"""The port's dynamic-activation serving bench
(``tpusparse_torch.bench.dynamic``) against the JAX package's, on the CPU.

- ``_x_pool`` bit for bit against the JAX ``_x_pool`` (and ``bench.abba``'s
  first pattern, which now comes from it).
- ``run_awsp``, ``run_asp`` and ``run_awsp_sweep`` at a small m on the
  CPU: every pattern's dynamic (device plan) y equal to its static (host
  plan) y bit for bit, the full plan's within 1e-5 of it; each within
  1e-3 of the float64 oracle; no time recorded.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpusparse_torch.bench import dynamic


@pytest.mark.parametrize("args", [
    (4096, 16, 256, 0.25, 5, 7, 1), (4096, 16, 256, 0.25, 5, 7, 8),
    (4096, 32, 128, 0.0625, 3, 7, 1), (1000, 4, 256, 0.5, 2, 3, 2)])
def test_x_pool_matches_jax(args):
    from tpusparse.bench.dynamic import _x_pool

    m, ng, span, live, patterns, seed, batch = args
    got = dynamic._x_pool(m, ng, span, live, patterns, seed=seed, batch=batch)
    want = _x_pool(m, ng, span, live, patterns, seed=seed, batch=batch)
    assert len(got) == len(want) == patterns
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batch", [1, 8])
def test_abba_first_pattern_is_the_pool_s(batch):
    from tpusparse_torch.bench.abba import x_pool

    first = dynamic._x_pool(4096, 16, 256, 0.25, 1, batch=batch)[0]
    np.testing.assert_array_equal(x_pool(4096, 16, 256, 0.25, batch),
                                  np.atleast_2d(first))


@pytest.mark.parametrize("batch", [1, 8])
def test_dynamic_static_full_equal_on_the_cpu(batch):
    a, f = dynamic._awsp_case(512, 384, 0.5, 2, "cpu")
    pool = dynamic._x_pool(512, f.n_groups, 256, 0.25, 3, batch=batch)
    for x in pool:
        xt = torch.from_numpy(x)
        y_dyn = dynamic._product(f, xt, "device")
        y_stat = dynamic._product(f, xt, torch.as_tensor(f.plan(x)))
        y_full = dynamic._product(f, xt, f._full_plan())
        assert torch.equal(y_dyn, y_stat)
        # the full plan adds the dead groups' zero products: the same sum
        # up to the order of its parts
        np.testing.assert_allclose(y_full.numpy(), y_dyn.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(
            y_dyn.numpy(), x.astype(np.float64) @ a.astype(np.float64),
            rtol=0, atol=1e-3)


@pytest.mark.parametrize("batch", [1, 8])
def test_run_awsp_cpu(batch):
    rec = dynamic.run_awsp(m=512, n=384, g=2, device="cpu", batch=batch,
                           verbose=False)
    assert rec["kind"] == "awsp" and rec["err"] <= 1e-3
    assert rec["ng"] == 2 and rec["batch"] == batch
    assert rec["us"] is None and rec["replan_ms"] is None
    # the JAX byte counts: live groups' slots at 5 B, plus X and Y
    assert rec["act_bytes"] < rec["full_bytes"] + batch * (512 + 384) * 4


@pytest.mark.parametrize("batch", [1, 8])
def test_run_asp_cpu(batch):
    rec = dynamic.run_asp(m=512, n=384, device="cpu", batch=batch,
                          verbose=False)
    assert rec["kind"] == "asp" and rec["err"] <= 1e-3 and rec["us"] is None


def test_sweep_cpu():
    recs = dynamic.run_awsp_sweep(m=1024, n=256, device="cpu",
                                  verbose=False)
    assert [r["live"] for r in recs] == [0.0625, 0.25, 0.5, 1.0]
    assert all(r["err"] <= 1e-3 and r["us"] is None for r in recs)
    assert recs[0]["act_bytes"] < recs[-1]["act_bytes"]
