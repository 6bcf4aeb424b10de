"""The sharded formats' packs and K8's halo strips in the port against the
JAX package, on the CPU.

- Packs are bit-identical: ``rsell_shard_pack`` (balance, sorted,
  contiguous; every array and the unpermute plan), ``bsr_shard_pack`` (n,
  m, ring, and the n pack of the 2-D mesh), ``tcsr_shard_pack`` (both
  tiers) and ``awsp_shard_slabs`` (m, ring), at D = 1, 3 and 4 (3 leaves
  ragged shards); the halo partition's slab width and padding
  (``_pick_rows`` and the 5% pad walk) are the JAX package's.
- K8's plain version with strips stays within 1e-6 of the JAX package's
  ``dia_spmv_pallas(..., xstrip_l=, xstrip_r=, vstrip=)`` in Pallas
  interpret mode (n >= 1024, so that ``fits`` holds), sym and not; with no
  strips it gives the bits it gave before strips were an input (zero
  strips), and ``check_reach`` refuses a plan whose reads pass the strips.
"""

import numpy as np
import pytest
import torch

from tpusparse.formats.awsp import AwspMatrix as JAwsp
from tpusparse.formats.rsell import rsell_shard_pack as jrsell_shards
from tpusparse.kernels import dia_spmv as jdk
from tpusparse.parallel import sparse as jsp
from tpusparse.testing import generators as jgen
from tpusparse_torch.formats import AwspMatrix
from tpusparse_torch.formats.rsell import rsell_shard_pack
from tpusparse_torch.kernels import dia_spmv as dk
from tpusparse_torch.parallel import sparse as sp

SHARDS = (1, 3, 4)


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def skew():
    return jgen.random_sparse_matrix(384, 640, density=0.15, seed=3,
                                     distribution="powerlaw")


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("assignment", ["balance", "sorted", "contiguous"])
def test_rsell_shard_pack_bits(skew, d, assignment):
    j = jrsell_shards(skew, d, assignment=assignment)
    t = rsell_shard_pack(skew, d, assignment=assignment)
    for k in ("cj", "ct", "idx", "vals", "group_map", "counts", "w_shard"):
        _eq(getattr(t, k), getattr(j, k), k)
    assert (t.shape, t.padded, t.nnz, t.run, t.n_shards) == \
        (j.shape, j.padded, j.nnz, j.run, j.n_shards)
    assert (t.perm_plan is None) == (j.perm_plan is None) \
        == (assignment == "contiguous")
    if j.perm_plan is not None:
        for a, b in zip(t.perm_plan, j.perm_plan):
            _eq(a, b, "perm_plan")
    assert repr(t) == repr(j)


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_bsr_shard_pack_bits(d, partition):
    a = jgen.random_sparse_matrix(640, 896, density=0.02, seed=5)
    j = jsp.bsr_shard_pack(a, d, partition=partition)
    t = sp.bsr_shard_pack(a, d, partition=partition)
    assert sorted(t) == sorted(j)
    for k, v in j.items():
        if isinstance(v, np.ndarray):
            _eq(t[k], v, k)
        else:
            assert t[k] == v, k


def _mixed_blocks():
    """Every output group two near-full tiles and two sparse ones (the
    TCSR tests' mixed matrix), 512 x 1280."""
    rng = np.random.default_rng(7)
    a = np.zeros((512, 1280), np.float32)
    for g in range(10):
        for k, fill in ((0, 0.97), (1, 0.97), (2, 0.08), (3, 0.08)):
            bi = (g + k) % 4
            tile = rng.uniform(0.1, 1, (128, 128)) * \
                (rng.random((128, 128)) < fill)
            a[bi * 128:(bi + 1) * 128, g * 128:(g + 1) * 128] = tile
    return a


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("kind", ["blockpruned", "mixed"])
def test_tcsr_shard_pack_bits(d, kind, monkeypatch):
    """Both tiers: the mixed matrix with the tier split's charge zeroed in
    both packages (as the TCSR tests do) keeps SELL and dense tiles."""
    from tpusparse.formats import tcsr as jtcsr
    from tpusparse_torch.formats import tcsr as ptcsr
    if kind == "mixed":
        a = _mixed_blocks()
        monkeypatch.setattr(jtcsr, "_TIER_SPLIT_BYTES", 0)
        monkeypatch.setattr(ptcsr, "_TIER_SPLIT_BYTES", 0)
    else:
        a = jgen.block_pruned_matrix(1024, 1280, block=128, keep_frac=0.3,
                                     fill=0.5, seed=9)
    j = jsp.tcsr_shard_pack(a, d)
    t = sp.tcsr_shard_pack(a, d)
    assert sorted(t) == sorted(j)
    assert ("blocks" in t) == (kind == "mixed") and "vals" in t
    for k, v in j.items():
        if isinstance(v, np.ndarray):
            _eq(t[k], v, k)
        else:
            assert t[k] == v, k


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("partition", ["m", "ring"])
@pytest.mark.parametrize("g", [1, 2])
def test_awsp_shard_slabs_bits(d, partition, g):
    a = jgen.random_sparse_matrix(1280, 384, density=0.1, seed=6)
    j = jsp.awsp_shard_slabs(JAwsp.from_dense(a, g=g), d, partition)
    t = sp.awsp_shard_slabs(AwspMatrix.from_dense(a, g=g, device="cpu"), d,
                            partition)
    for name, jt, tt in zip(("idx", "vals"), j, t):
        _eq(tt.numpy(), np.asarray(jt), name)


def _jax_slab_rows(offsets, sym, n, d):
    """The JAX package's inline slab rule (``dia_spmm_sharded``), stated on
    its own ``_pick_rows``."""
    hrows = jdk.halo_rows(offsets, sym)
    nr0 = -(-(-(-n // d)) // 128)
    rows = jdk._pick_rows(len(offsets), hrows, nr0)
    best, best_pad = rows, (-n) % (d * rows * 128)
    r = rows
    while r >= hrows:
        pad = (-n) % (d * r * 128)
        if pad < best_pad:
            best, best_pad = r, pad
        if pad <= 0.05 * n:
            best, best_pad = r, pad
            break
        r -= hrows
    return best


@pytest.mark.parametrize("k,hr,nr", [(1, 8, 1), (3, 16, 8192), (14, 88, 8788),
                                     (32, 512, 100), (5, 8, 333)])
def test_pick_rows_is_jax(k, hr, nr):
    assert sp._pick_rows(k, hr, nr) == jdk._pick_rows(k, hr, nr)


@pytest.mark.parametrize("dims,points", [((1024, 1024), None),
                                         ((104, 104, 104), 27),
                                         ((512, 512), None), ((64, 64), None),
                                         ((37, 41), 9)])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_halo_slab_width_is_jax(dims, points, d):
    """Each rank's slab (rows * 128 * D, padded with zero columns) is the
    JAX package's, from the offsets alone (no pack needed)."""
    from itertools import product
    nd = len(dims)
    strides = np.cumprod((1,) + dims[::-1][:-1])[::-1]
    steps = [o for o in product((-1, 0, 1), repeat=nd)] if points else \
        [tuple(int(i == ax) * s for i in range(nd)) for ax in range(nd)
         for s in (1, -1)] + [(0,) * nd]
    offs = sorted({int(np.dot(o, strides)) for o in steps})
    sym_offs = tuple(o for o in offs if o >= 0)
    n = int(np.prod(dims))
    for offsets, sym in ((sym_offs, True), (tuple(offs), False)):
        assert sp.halo_slab_rows(len(offsets), dk.halo_rows(offsets, sym),
                                 n, d) == _jax_slab_rows(offsets, sym, n, d)


@pytest.fixture(scope="module")
def strip_cases():
    """Random operators, x and strips, each through the JAX package's K8
    with strips in interpret mode. n is a multiple of the JAX kernel's
    block (rows * 128), as on the halo partition's slabs: the JAX kernel
    reads ``xstrip_r`` from its padded length, the port's from n."""
    rng = np.random.default_rng(0)
    out = []
    for sym, offs, n in ((True, (0, 1, 40), 2048),
                         (False, (-300, -5, 0, 2, 129), 2048),
                         (True, (0, 1, 33, 1024), 4096)):
        k = len(offs)
        hs = dk.strip_width(offs, sym)
        vals = rng.standard_normal((k, n)).astype(np.float32)
        x = rng.standard_normal(n).astype(np.float32)
        sl, sr = (rng.standard_normal(hs).astype(np.float32)
                  for _ in range(2))
        vs = rng.standard_normal((k, hs)).astype(np.float32)
        assert jdk.fits(offs, sym, n)
        y = np.asarray(jdk.dia_spmv_pallas(
            offs, vals, x, sym=sym, n=n, xstrip_l=sl, xstrip_r=sr,
            vstrip=vs if sym else None, interpret=True))
        out.append((offs, sym, n, vals, x, sl, sr, vs, y))
    return out


@pytest.mark.parametrize("i", range(3))
def test_k8_plain_with_strips_matches_jax(strip_cases, i):
    offs, sym, n, vals, x, sl, sr, vs, want = strip_cases[i]
    t = torch.from_numpy
    got = dk.dia_spmv_plain(offs, t(vals), t(x), sym=sym, n=n,
                            xstrip_l=t(sl), xstrip_r=t(sr),
                            vstrip=t(vs) if sym else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the public wrapper takes the plain version for CPU tensors
    got2 = dk.dia_spmv(offs, t(vals), t(x), sym=sym, n=n, xstrip_l=t(sl),
                       xstrip_r=t(sr), vstrip=t(vs) if sym else None)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("i", range(3))
def test_k8_plain_without_strips_unchanged(strip_cases, i):
    """No strips: zeros outside [0, n), the bits of the version before
    strips (reads masked to 0); zero strips give the same bits."""
    offs, sym, n, vals, x, *_ = strip_cases[i]
    v, xt = torch.from_numpy(vals), torch.from_numpy(x)
    got = dk.dia_spmv_plain(offs, v, xt, sym=sym, n=n)
    p = torch.arange(n)
    want = torch.zeros(n)
    for j, d in enumerate(offs):             # the earlier plain version
        q = p + d
        ok = (q >= 0) & (q < n)
        want = want + v[j] * torch.where(ok, xt[q.clamp(0, n - 1)], 0.0)
        if sym and d > 0:
            rc = (p - d).clamp(min=0)
            want = want + torch.where(p - d >= 0, v[j, rc] * xt[rc], 0.0)
    assert torch.equal(got, want)
    hs = dk.strip_width(offs, sym)
    z = torch.zeros(hs)
    assert torch.equal(got, dk.dia_spmv_plain(
        offs, v, xt, sym=sym, n=n, xstrip_l=z, xstrip_r=z,
        vstrip=torch.zeros(len(offs), hs)))


def test_k8_plan_reach_is_checked():
    offs = (0, 1, 900)
    plan = dk.dia_plan(offs, True)
    dk.check_reach(plan, dk.strip_width(offs, True))
    with pytest.raises(ValueError, match="past the"):
        dk.check_reach(plan, 896)


def test_read_bytes_count_live_values():
    """SELL, BSR and TCSR bound their kernels on the bytes a product must
    read: live values with their one-byte indices (SELL, TCSR's SELL
    tier), real blocks (BSR, TCSR's dense tier), not the stored pads."""
    from tpusparse_torch.bench.roofline import format_bytes
    from tpusparse_torch.formats import BsrMatrix, SellMatrix, TcsrMatrix
    from tpusparse_torch.formats import tcsr as ptcsr

    a = jgen.random_sparse_matrix(512, 384, density=0.1, seed=8)
    s = SellMatrix.from_dense(a, device="cpu")
    assert format_bytes(s) == s.read_bytes() == 5 * int((a != 0).sum())
    assert s.read_bytes() < s.device_bytes()
    b = BsrMatrix.from_dense(_mixed_blocks(), device="cpu")
    assert format_bytes(b) == b.read_bytes() == \
        b.n_real * (128 * 128 * 4 + 8)
    assert b.read_bytes() <= b.device_bytes()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptcsr, "_TIER_SPLIT_BYTES", 0)
        t = TcsrMatrix.from_dense(_mixed_blocks(), device="cpu")
    assert t.n_sell and t.n_dense
    live = int((t.vals != 0).sum())
    assert format_bytes(t) == t.read_bytes() == \
        live * 5 + t.n_sell * 8 + t.bsr.read_bytes()
    assert t.read_bytes() < t.device_bytes()
