"""K8's plan (``kernels/dia_spmv.py:dia_plan``) and its walk, on the CPU.

The CUDA kernel runs only on the card, so its walk is replayed here in
numpy from the plan, as the kernel does it: each tile's windows copied
once into a shared array (zeros outside [0, n)), every term read from
there at the plan's index (or from global memory with bounds tests where
its window was not staged), each product and sum rounded to fp32 in the
TPU kernel's order. The replay must give ``dia_spmv_plain``'s bits.

- Windows: x's and each vals row's shifts are cut into groups where
  neighbours lie more than T apart; every term's shift lies in exactly one
  window of its source; a window starts on a 16-byte boundary at or below
  its first read and covers its last; staged windows are disjoint in
  shared memory and within the budget; the least used stay in global
  memory first.
- The tile: the first of ``TILES`` whose windows all fit two blocks an SM.
- ``DiaMatrix.plan`` is built once per matrix, and ``spmv`` passes it on.
- ``halo_rows`` and ``fits`` still match the JAX package's, and the plain
  version still matches the JAX K8 in interpret mode on a 27-point stencil
  (one call, in a module fixture).
"""

import numpy as np
import pytest
import torch

from tpusparse.kernels.dia_spmv import dia_spmv_pallas
from tpusparse.kernels.dia_spmv import fits as jfits
from tpusparse.kernels.dia_spmv import halo_rows as jhalo
from tpusparse.testing import generators as jgen
from tpusparse_torch.formats import DiaMatrix
from tpusparse_torch.formats import dia as dia_mod
from tpusparse_torch.kernels import dia_spmv as k8
from tpusparse_torch.kernels.dia_spmv import (BLOCKS, PASS, TILES, budget,
                                              dia_plan, dia_spmv_plain, fits,
                                              halo_rows, plan_terms,
                                              shift_groups)
from tpusparse_torch.testing import generators as tgen

# HPCG's 27-point stencil on 104^3 stores these (sym)
S27 = (0, 1, 103, 104, 105, 10711, 10712, 10713, 10815, 10816, 10817, 10919,
       10920, 10921)
RNG = np.random.default_rng(5)
# name -> (offsets, sym)
OPERATORS = {
    "laplace2d": ((0, 1, 1024), True),
    "stencil27-104": (S27, True),
    "stencil27-small": ((0, 1, 7, 8, 9, 55, 56, 57, 63, 64, 65, 71, 72, 73),
                        True),
    "asym": ((-300, -5, 0, 2, 129), False),
    "negative_only": ((-700, -3, -1), False),
    "far": ((0, 1, 5000), True),
    "diag32": (tuple(sorted(RNG.choice(np.arange(-3000, 3000), 32,
                                       replace=False).tolist())), False),
    "halo512": ((-65535, 0, 65535), False),
    "sym32": (tuple(range(0, 32 * 37, 37)), True),
    "sym_no_main": ((3, 40, 1100), True),
}
# (tile, blocks an SM) plans besides the package's; the last two leave
# windows in global memory (at 1000 blocks an SM, all of them)
TRIED = [(1024, 8), (1024, 4), (2048, 2), (4096, 2), (1024, 16),
         (1024, 1000)]


def _sources(terms):
    """{source: shifts}: x (-1) read at each term's e, row r at its s."""
    out = {-1: [t[0] for t in terms]}
    for e, s, r in terms:
        out.setdefault(r, []).append(s)
    return out


def replay(plan, vals, x, n):
    """K8's walk in numpy: y (n,) fp32."""
    vals = np.asarray(vals, np.float32)
    x = np.asarray(x, np.float32)
    tile = plan.tile
    y = np.zeros(n, np.float32)

    def masked(src, g, hi):
        ok = (g >= 0) & (g < hi)
        return np.where(ok, src[np.clip(g, 0, len(src) - 1)], 0) \
            .astype(np.float32)

    for base in range(0, n, tile):
        smem = np.full(plan.smem_bytes // 4, np.nan, np.float32)
        for src, lo, ln, off in plan.windows:
            g = base + lo + np.arange(ln)
            smem[off:off + ln] = masked(x if src < 0 else vals[src], g, n)
        q = np.arange(min(tile, n - base))
        p = base + q
        acc = np.zeros(q.size, np.float32)
        for e, s, r, xi, vi in plan.terms:
            xv = smem[q + xi] if xi >= 0 else masked(x, p + e, n)
            vv = smem[q + vi] if vi >= 0 else masked(vals[r], p + s, n + s)
            acc = (acc + (vv * xv).astype(np.float32)).astype(np.float32)
        y[p] = acc
    return y


def _case(offsets, sym, n, seed=0, ldv=None):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-1, 1, (len(offsets), ldv or n)).astype(np.float32)
    x = (rng.uniform(-1, 1, n) * (rng.random(n) < 0.5)).astype(np.float32)
    return vals, x


def _plans(offsets, sym):
    """The package's plan and the plan at each launch shape tried."""
    return [dia_plan(offsets, sym)] + [dia_plan(offsets, sym, t, b)
                                       for t, b in TRIED]


def _same_bits(got, want):
    assert np.array_equal(np.asarray(got).view(np.int32),
                          np.asarray(want).view(np.int32))


@pytest.mark.parametrize("name", list(OPERATORS))
def test_windows_cover_each_shift_once_aligned(name):
    offsets, sym = OPERATORS[name]
    terms = plan_terms(offsets, sym)
    assert len(terms) == len(offsets) + (sum(d > 0 for d in offsets)
                                         if sym else 0)
    for plan, (_, blocks) in zip(_plans(offsets, sym),
                                 [(None, BLOCKS)] + TRIED):
        tile = plan.tile
        assert tile % PASS == 0
        assert plan.smem_bytes <= max(0, budget(blocks))
        assert [t[:3] for t in plan.terms] == terms
        staged = {}
        for src, lo, ln, off in plan.windows:
            assert lo % 4 == 0 and ln % 4 == 0 and off % 4 == 0
            staged[off] = (src, lo, ln)
        ends = sorted((off, off + ln) for off, (_, _, ln) in staged.items())
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        assert not ends or 4 * ends[-1][1] == plan.smem_bytes
        for src, shifts in _sources(terms).items():
            groups = shift_groups(shifts, tile)
            for v in set(shifts):         # each shift in exactly one group
                assert sum(lo <= v <= hi for lo, hi in groups) == 1
            for a, b in zip(groups, groups[1:]):
                assert b[0] - a[1] > tile
        for e, s, r, xi, vi in plan.terms:
            for src, shift, idx in ((-1, e, xi), (r, s, vi)):
                if idx < 0:
                    continue
                win = [(off, lo, ln) for off, (sr, lo, ln) in staged.items()
                       if sr == src and off <= idx < off + ln]
                assert len(win) == 1, (src, shift, idx)
                off, lo, ln = win[0]
                assert idx == off + shift - lo and shift >= lo
                assert shift - lo + tile <= ln    # the tile's last read


@pytest.mark.parametrize("name", list(OPERATORS))
def test_windows_first_read_boundary(name):
    """A staged window starts at the 16-byte boundary at or below the first
    shift of its group, and ends on the one at or above its last read."""
    offsets, sym = OPERATORS[name]
    for plan in _plans(offsets, sym):
        for src, shifts in _sources(plan_terms(offsets, sym)).items():
            for lo, hi in shift_groups(shifts, plan.tile):
                mine = [w for w in plan.windows
                        if w[0] == src and w[1] == lo - lo % 4]
                assert len(mine) <= 1
                for _, wlo, ln, _ in mine:
                    assert wlo <= lo < wlo + 4
                    assert ln == -(-(plan.tile + hi - wlo) // 4) * 4


@pytest.mark.parametrize("shape", [None] + TRIED)
@pytest.mark.parametrize("n", [1024, 1100, 2051, 5000, 9216, 30000])
@pytest.mark.parametrize("name", ["laplace2d", "asym", "negative_only",
                                  "far", "stencil27-small", "diag32",
                                  "sym32", "sym_no_main"])
def test_replay_gives_the_plain_bits(name, n, shape):
    offsets, sym = OPERATORS[name]
    vals, x = _case(offsets, sym, n, seed=n)
    plan = dia_plan(offsets, sym, *(shape or ()))
    want = dia_spmv_plain(offsets, torch.from_numpy(vals),
                          torch.from_numpy(x), sym=sym, n=n).numpy()
    _same_bits(replay(plan, vals, x, n), want)


@pytest.mark.parametrize("blocks", [6, 12, 24, 1000])
@pytest.mark.parametrize("name", ["laplace2d", "stencil27-small", "asym",
                                  "diag32"])
def test_replay_with_windows_in_global_memory(name, blocks):
    """Over budget, the least used windows stay in global memory and their
    terms read there, on a vals array wider than n; the bits do not
    change."""
    offsets, sym = OPERATORS[name]
    n = 3000
    vals, x = _case(offsets, sym, n, seed=blocks, ldv=3001)
    plan = dia_plan(offsets, sym, 1024, blocks)
    assert plan.smem_bytes <= max(0, budget(blocks))
    if blocks == 1000:
        assert plan.windows == () and all(t[3] < 0 and t[4] < 0
                                          for t in plan.terms)
    want = dia_spmv_plain(offsets, torch.from_numpy(vals),
                          torch.from_numpy(x), sym=sym, n=n).numpy()
    _same_bits(replay(plan, vals, x, n), want)


@pytest.mark.parametrize("blocks", [3, 4, 8])
def test_unstaged_windows_are_the_least_used(blocks):
    """Over budget, the windows used by one term leave shared memory before
    any used by two or more (x's, a near row's direct and mirror)."""
    plan = dia_plan(S27, True, 1024, blocks)
    wins = k8._windows(plan_terms(S27, True), 1024)
    kept = {(w[0], w[1]) for w in plan.windows}
    gone = [w for w in wins if (w["src"], w["lo"]) not in kept]
    held = [w for w in wins if (w["src"], w["lo"]) in kept]
    assert gone and held
    assert max(w["uses"] for w in gone) <= min(w["uses"] for w in held)


def test_tiles_of_the_two_points():
    """The tile the rule picks, the windows and the shared memory at the
    two measured points."""
    lap = dia_plan((0, 1, 1024), True)
    assert (lap.tile, lap.smem_bytes) == (1024, 28688)
    assert lap.windows[0][:3] == (-1, -1024, 3072)         # one x window
    s27 = dia_plan(S27, True)
    assert (s27.tile, s27.smem_bytes) == (1024, 110464)
    xw = [w for w in s27.windows if w[0] < 0]
    assert len(xw) == 3 and all(w[2] == 1240 for w in xw)  # 211-wide spans
    assert all(t[3] >= 0 and t[4] >= 0 for t in s27.terms)


@pytest.mark.parametrize("name", list(OPERATORS))
def test_tile_rule_stages_every_window_where_one_fits(name):
    """The rule takes the largest tile of TILES whose windows all fit; only
    past the smallest are windows left in global memory."""
    offsets, sym = OPERATORS[name]
    plan = dia_plan(offsets, sym)
    fitting = [t for t in TILES
               if 4 * sum(w["len"] for w in k8._windows(
                   plan_terms(offsets, sym), t)) <= budget(BLOCKS)]
    assert plan.tile == (fitting[0] if fitting else TILES[-1])
    if fitting:
        assert all(t[3] >= 0 and t[4] >= 0 for t in plan.terms)


def test_plan_errors():
    with pytest.raises(ValueError, match="diagonals"):
        dia_plan((), False)
    with pytest.raises(ValueError, match="diagonals"):
        dia_plan(tuple(range(33)), False)
    with pytest.raises(ValueError, match="multiple"):
        dia_plan((0, 1), True, tile=1500, blocks=2)


def test_plan_words_lay_out_terms_then_windows():
    plan = dia_plan(S27, True, tile=1024, blocks=4)
    words = list(plan.words)
    nt = len(plan.terms)
    assert words[:5 * nt] == [v for t in plan.terms for v in t]
    assert words[5 * nt:] == [v for w in plan.windows for v in w]
    assert len(plan.terms) <= 63 and len(plan.windows) <= 127


def test_plan_built_once_per_matrix(monkeypatch):
    calls = []
    real = dia_mod.dia_plan

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(dia_mod, "dia_plan", counting)
    d = DiaMatrix.from_csr(tgen.stencil_csr((32, 32)), device="cpu")
    x = tgen.random_sparse_vector(1024, 0.5, seed=1)
    assert calls == []             # not at packing
    d.spmv(x)
    p = d.plan
    assert d.plan is p and len(calls) == 1
    assert p[:4] == real(d.offsets, d.sym)[:4]
    for _ in range(3):
        d.spmv(x)
    assert len(calls) == 1 and d.plan is p


def test_spmv_passes_the_matrix_plan(monkeypatch):
    seen = []
    real = dia_mod.dia_spmv

    def spy(*a, **k):
        seen.append(k.get("plan"))
        return real(*a, **k)

    monkeypatch.setattr(dia_mod, "dia_spmv", spy)
    d = DiaMatrix.from_csr(tgen.stencil_csr((40, 30)), device="cpu")
    y = d.spmv(tgen.random_sparse_vector(1200, 0.5, seed=2))
    assert seen == [d.plan] and y.shape == (1200,)


def test_vec_body_by_shape():
    vals = torch.zeros((3, 1024))
    x = torch.zeros(1024)
    assert k8.vec_body(vals, x, 1024)
    assert not k8.vec_body(vals, x[:1023], 1023)       # n % 4
    big = torch.zeros((3, 1027))
    assert not k8.vec_body(big[:, :1024], x, 1024)     # ldv % 4
    assert k8.vec_body(torch.zeros((3, 1028))[:, :1024], x, 1024)
    assert not k8.vec_body(vals, torch.zeros(1025)[1:], 1024)  # x offset


def test_strided_vals_view_on_cpu():
    """A vals view with a row stride above n is what the kernel takes; the
    plain version reads it the same."""
    offsets, sym = OPERATORS["laplace2d"]
    n = 2048
    vals, x = _case(offsets, sym, n, seed=4, ldv=2061)
    v = torch.from_numpy(vals)
    want = dia_spmv_plain(offsets, v[:, :n].contiguous(),
                          torch.from_numpy(x), sym=sym, n=n)
    got = k8.dia_spmv(offsets, v[:, :n], torch.from_numpy(x), sym=sym, n=n)
    assert torch.equal(got, want)


def test_halo_rows_and_fits_still_match_jax():
    for offs, sym in list(OPERATORS.values()) + [((-65536, 0), False),
                                                  ((0, 65536), True)]:
        for n in (1023, 1024, 1089, 1 << 20, 1124864):
            assert halo_rows(offs, sym) == jhalo(offs, sym)
            assert fits(offs, sym, n) == jfits(offs, sym, n)
    assert halo_rows(S27, True) == 88 and fits(S27, True, 104 ** 3)


def _scipy_at(jc):
    """scipy CSR of A.T from the JAX package's CSR (never densified)."""
    import scipy.sparse as sp
    return sp.csr_matrix((jc.values, jc.col_idx, jc.row_ptr), shape=jc.shape)


@pytest.fixture(scope="module")
def jax_stencil27():
    """The JAX K8 in interpret mode on a 27-point stencil (12^3: n % 128
    != 0), and the port's pack of the same operator."""
    jc = jgen.stencil_csr((12, 12, 12), points=27)
    tc = tgen.stencil_csr((12, 12, 12), points=27)
    d = DiaMatrix.from_csr(tc, device="cpu")
    x = jgen.random_sparse_vector(d.shape[0], 0.5, seed=41)
    jy = np.asarray(dia_spmv_pallas(d.offsets, d.vals.numpy(), x, sym=d.sym,
                                    n=d.shape[1], interpret=True))
    return jc, d, x, jy


def test_plain_matches_jax_interpret_on_27_point(jax_stencil27):
    jc, d, x, jy = jax_stencil27
    n = d.shape[1]
    assert d.sym and len(d.offsets) == 14 and fits(d.offsets, d.sym, n)
    y = dia_spmv_plain(d.offsets, d.vals, torch.from_numpy(x), sym=d.sym,
                       n=n)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-4)
    oracle = _scipy_at(jc).T.astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(y.numpy(), oracle, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", TRIED)
def test_replay_matches_jax_interpret_on_27_point(jax_stencil27, shape):
    jc, d, x, jy = jax_stencil27
    n = d.shape[1]
    got = replay(dia_plan(d.offsets, d.sym, *shape), d.vals.numpy(), x, n)
    np.testing.assert_allclose(got, jy, rtol=0, atol=1e-4)
