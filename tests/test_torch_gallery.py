"""The port's gallery (``tpusparse_torch.bench.gallery``) and its three
generators against the JAX package's, on the CPU.

- The 13 workloads: the same names, and each one's CSR bit for bit
  (``rmat_csr``, ``banded_defects_csr`` and ``nm_pruned_matrix`` at the
  gallery's own parameters, ``rmat_csr(12, 24, seed=3, symmetric=True)``
  among them).
- Each workload's candidate list and route at B = 1 and 8, the JAX names
  mapped to the port's (``NAMES``), from the JAX package's own statistics
  (nothing is packed).
- The gallery's X, bit for bit.
- ``run_workload`` on ``stencil2d-64`` on the CPU: every candidate within
  1e-3 of the float64 oracle, no time recorded.

No JAX bench runs here: only the JAX generators, statistics and gates.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from tpusparse_torch.bench import gallery as pg

NAMES = list(pg.WORKLOADS)


@pytest.fixture(scope="module")
def built():
    """Each workload built by both packages, with its statistics."""
    from tpusparse.bench import gallery as jg
    from tpusparse.formats.auto import matrix_stats_csr as jstats
    from tpusparse.formats.csr import CsrMatrix as JaxCsr

    from tpusparse_torch.formats.auto import matrix_stats_csr

    out = {}
    for name in NAMES:
        a = jg.WORKLOADS[name]["build"]()
        if not isinstance(a, JaxCsr):
            a = JaxCsr.from_dense(np.asarray(a))
        p = pg.build(name)
        out[name] = (a, jstats(a), p, matrix_stats_csr(p))
    return jg, out


def test_workload_names_match_jax(built):
    jg, _ = built
    assert NAMES == list(jg.WORKLOADS)
    assert all(pg.WORKLOADS[k]["note"] for k in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_workload_bits_match_jax(built, name):
    a, sj, p, sp = built[1][name]
    assert p.shape == a.shape
    for field in ("row_ptr", "col_idx", "values"):
        np.testing.assert_array_equal(getattr(p, field), getattr(a, field),
                                      err_msg=f"{name}.{field}")
    assert sp == sj


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_candidates_and_route_match_jax(built, name, batch):
    jg, wl = built
    a, sj, p, sp = wl[name]
    want = [pg.NAMES[e["name"]] for e in jg.candidates(a, sj, batch=batch)]
    assert [e["name"] for e in pg.candidates(p, sp, batch=batch)] == want
    assert pg.route_name(p, sp, batch) == \
        pg.NAMES[jg.route_name(a, sj, batch)]


@pytest.mark.parametrize("kw", [dict(m=4096, batch=1), dict(m=4096, batch=8),
                                dict(m=4096, batch=1, x_seed=5)])
def test_gallery_x_matches_jax(kw):
    # the JAX run_workload's X (tpusparse/bench/gallery.py)
    rng = np.random.default_rng(kw.get("x_seed", 0) ^ 0xA11)
    want = rng.uniform(-1.0, 1.0, size=(kw["batch"], kw["m"])) \
        .astype(np.float32)
    want = want[0] if kw["batch"] == 1 else want
    np.testing.assert_array_equal(pg.gallery_x(**kw), want)


@pytest.mark.parametrize("batch", [1, 8])
def test_run_workload_cpu_checks_every_candidate(built, batch):
    jg, wl = built
    a, sj, p, sp = wl["stencil2d-64"]
    rec = pg.run_workload("stencil2d-64", batch=batch, device="cpu",
                          verbose=False)
    assert list(rec["rows"]) == [e["name"] for e in
                                 pg.candidates(p, sp, batch=batch)]
    assert rec["routed"] == pg.NAMES[jg.route_name(a, sj, batch)]
    assert rec["best"] is None and rec["regret_pct"] is None
    for name, row in rec["rows"].items():
        assert row["max_abs_err"] <= 1e-3, name
        assert row["us"] is None and row["roofline"] is None, name
    out = io.StringIO()
    pg.render([rec], out)
    assert "stencil2d-64" in out.getvalue()


def test_bytes_cap_skips_without_running(monkeypatch):
    """A pack past the cap is recorded as ``skipped: bytes`` and never
    run (the JAX gallery's 1.8 GB rule)."""
    monkeypatch.setattr(pg, "_BYTES_CAP", 1.0)
    rec = pg.run_workload("stencil2d-64", device="cpu", verbose=False)
    assert all(r["skipped"] == "bytes" and r["us"] is None
               for r in rec["rows"].values())
    assert rec["best"] is None


def test_main_lists_and_checks(capsys):
    assert pg.main(["--list"]) == 0
    assert capsys.readouterr().out.count("\n") == len(NAMES)
