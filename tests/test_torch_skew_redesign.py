"""What the redesigned K4 (``csrc/rsell_spmv.cu``) and K9
(``csrc/asp_spmv.cu``) rest on, checked on the CPU (no kernel runs here):

- K4's work plan (``kernels/rsell_spmv.py:rsell_plans``): one plan per
  batch tile; every chunk lies in exactly one item, the items are whole
  chunks of one group, sorted with ``gptr`` consistent, each reading at
  most ``MAX_WINDOWS`` runs of one x window, and its row names those
  windows and the chunks where their runs start; the plan fills the card
  at 132, 78 and 1 SMs on the headline and skew packs; bad groups and
  window caps are refused;
- a host replay of each new walk gives the plain product (1e-5) and the
  JAX package's kernels in interpret mode (1e-4): K4's items in order,
  the x windows each stages, each row's window found by counting run
  starts, the warps' rows (w, w+4, ... from 2 batch rows, a quarter of the
  chunks each at one), the warps' sums in order, then each group's
  partials as the second kernel adds them; K9's cluster ranks each
  taking its run of the live windows' rows in stages of 32, warp w rows
  8w .. 8w+7 of a stage, the warps' sums in order, then the ranks' sums in
  rank order, with m and n not multiples of 128 and lda % 4 != 0;
- the launch shapes: K9's clusters give each block an SM of its own, the
  largest cluster that does, and its ring fits the H100's shared memory;
  K4's windows and sums fit without an opt-in at its blocks an SM; the C
  entries' argument counts match their ctypes signatures; off the card
  the wrappers raise.
"""

import re

import numpy as np
import pytest
import torch

from tpusparse.kernels.asp_spmv import AspMatrix as JAsp
from tpusparse.formats.rsell import RsellMatrix as JRsell
from tpusparse_torch.formats import AspMatrix, CsrMatrix, RsellMatrix
from tpusparse_torch.formats.rsell import rsell_pack_csr
from tpusparse_torch.kernels import _build, block_items
from tpusparse_torch.kernels import asp_spmv as k9
from tpusparse_torch.kernels import rsell_spmv as k4
from tpusparse_torch.kernels.awsp_spmv import device_group_plan
from tpusparse_torch.kernels.dense import batch_tile
from tpusparse_torch.testing import generators, reference

ATOL_PLAIN = 1e-5
ATOL_JAX = 1e-4
WARPS = 4                      # csrc/sell_common.cuh kWarps
H100_SMS = 132
H100_SMEM = 232448 - 1024      # _build.SMEM_LIMIT
SM_SMEM = 233472               # _build.SM_SMEM

# RSELL packs: name -> (m, n, density, distribution, seed, sorted, run)
PACKS = {"run": (512, 640, 0.2, "powerlaw", 1, True, 8),
         "flat": (256, 2048, 0.01, "uniform", 6, True, 1),
         "unsorted": (384, 256, 0.3, "uniform", 17, False, 8)}


def _matrix(m, n, d, dist, seed):
    return generators.random_sparse_matrix(m, n, density=d, seed=seed,
                                           distribution=dist)


@pytest.fixture(scope="module")
def full_packs():
    """The headline RSELL pack (4096^2, d = 0.5) and the router's skew pack
    (8192^2 powerlaw, d = 0.15): cj, ct and the number of groups."""
    out = {}
    for name, args in {"headline": (4096, 4096, 0.5, "uniform", 0),
                       "skew": (8192, 8192, 0.15, "powerlaw", 0)}.items():
        p = rsell_pack_csr(CsrMatrix.from_dense(_matrix(*args)))
        out[name] = (p["cj"], p["ct"], p["padded"][1] // 128)
    return out


def _plans(cj, ct, nb, sms):
    return k4.host_plans(cj, ct, nb, sms)


def _check_plan(items, gptr, cj, ct, nb, max_windows):
    """Every chunk once, whole chunks of one group, sorted, at most
    ``max_windows`` window runs, and the row's windows and run starts."""
    assert items.dtype == np.int32 and gptr.dtype == np.int32
    assert items.shape[1] == k4.ITEM_INTS
    assert gptr.shape == (nb + 1,) and gptr[0] == 0 and gptr[-1] == len(items)
    assert np.all(np.diff(items[:, 0]) >= 0)
    for j in range(nb):
        assert np.all(items[gptr[j]:gptr[j + 1], 0] == j)
    seen = np.zeros(len(cj), np.int32)
    nw = (k4.ITEM_INTS + 1) // 2 - 1
    for row in items:
        g, r0, r1 = row[:3]
        assert r0 % 8 == 0 and r1 % 8 == 0 and r1 > r0
        k0, k1 = r0 // 8, r1 // 8
        seen[k0:k1] += 1
        assert np.all(cj[k0:k1] == g)
        starts = [k0] + [k for k in range(k0 + 1, k1) if ct[k] != ct[k - 1]]
        assert len(starts) <= max_windows
        wins, runs = row[3:3 + nw], row[3 + nw:]
        assert list(wins[:len(starts)]) == [ct[k] for k in starts]
        assert np.all(wins[len(starts):] == -1)
        assert list(runs[:len(starts) - 1]) == starts[1:]
        assert np.all(runs[len(starts) - 1:] == 2**31 - 1)
    assert np.all(seen == 1)


@pytest.mark.parametrize("sms", [132, 78, 1])
@pytest.mark.parametrize("name", list(PACKS))
def test_k4_plan_covers_every_chunk_once(name, sms):
    r = RsellMatrix.from_dense(_matrix(*PACKS[name][:5]), device="cpu")
    assert (r.perm_src is not None, r.run) == PACKS[name][5:]
    cj, ct = r.cj.numpy(), r.ct.numpy()
    nb = r.padded[1] // 128
    plans = _plans(cj, ct, nb, sms)
    assert set(plans) == {1, 2, 4, 8}            # one plan per batch tile
    for bt, (items, gptr) in plans.items():
        _check_plan(items, gptr, cj, ct, nb, k4.MAX_WINDOWS[bt])


@pytest.mark.parametrize("sms", [132, 78, 1])
@pytest.mark.parametrize("name", ["headline", "skew"])
def test_k4_plan_fills_the_card(full_packs, name, sms):
    """At least three quarters of the card's resident blocks, and no more
    items than a cut by size plus a cut by windows give: the headline
    pack's ~10 chunks a tile never need a window cut, so it keeps about one
    wave; the skew pack's tail groups (one chunk a window) are cut at 8
    windows up to 4 batch rows and at 4 at 8 rows."""
    cj, ct, nb = full_packs[name]
    runs = 1 + np.count_nonzero((ct[1:] != ct[:-1]) | (cj[1:] != cj[:-1]))
    for bt, (items, gptr) in _plans(cj, ct, nb, sms).items():
        slots = sms * k4.SHAPES[bt][0]
        floor = -(-runs // k4.MAX_WINDOWS[bt])     # the window cut alone
        assert len(items) >= min(0.75 * slots, len(cj)), (bt, len(items))
        assert len(items) >= floor - nb, (bt, len(items))
        assert len(items) <= slots + floor + 2 * (nb + 1), (bt, len(items))
        if name == "headline" and sms > 1:
            assert len(items) <= slots + nb, (bt, len(items))
        if sms == 78 and bt in (1, 8):
            _check_plan(items, gptr, cj, ct, nb, k4.MAX_WINDOWS[bt])


def test_k4_plan_refuses_bad_groups_and_caps():
    cj = np.array([0, 0, 2], np.int32)
    with pytest.raises(ValueError, match="groups"):
        _plans(cj, cj, 2, 132)
    for cap in (0, 9):
        with pytest.raises(ValueError, match="max_windows"):
            k4.window_items(cj, cj, 3, 4, cap)


def test_k4_cut_by_size_and_windows():
    """Group 1's 8 one-chunk windows cut at 2 windows; group 0's one
    window of 5 chunks cut at 2 chunks; group 2 empty; the zero tail of
    group 0 after the last group joins group 0's items, in stream order."""
    cj = np.array([0] * 5 + [1] * 8 + [3, 0], np.int32)
    ct = np.array([5] * 5 + list(range(8)) + [0, 0], np.int32)
    items, gptr = k4.window_items(cj, ct, 4, 2, 2)
    assert [tuple(r[:3]) for r in items] == [
        (0, 0, 16), (0, 16, 32), (0, 32, 40), (0, 112, 120), (1, 40, 56),
        (1, 56, 72), (1, 72, 88), (1, 88, 104), (3, 104, 112)]
    assert list(gptr) == [0, 4, 8, 8, 9]
    _check_plan(items, gptr, cj, ct, 4, 2)
    empty = k4.window_items(np.zeros(0, np.int32), np.zeros(0, np.int32), 2,
                            8, 8)
    assert empty[0].shape == (0, k4.ITEM_INTS) and list(empty[1]) == [0] * 3


# ---- the kernels' order of work, replayed ----------------------------------

def _group_sum(parts, bt, batch):
    """A group's partials added as the second kernel adds them
    (``csrc/block_items.cuh``): at 8 batch rows in item order from 0; at
    1-4 by the group reduce of ``work_items.cuh``, 32 slices (slice r adds
    items r, r + 32, ... in order), then the slices in order."""
    zero = np.zeros((batch, 128), np.float32)
    if bt == 8:
        s = zero
        for p in parts:
            s = (s + p).astype(np.float32)
        return s
    total = zero
    for r in range(32):
        s = zero
        for p in parts[r::32]:
            s = (s + p).astype(np.float32)
        total = (total + s).astype(np.float32)
    return total


def _k4_rows(r0, r1, warp, bt):
    """The rows a warp of K4 sums, in order: from 2 batch rows the item's
    rows warp, warp + 4, ...; at one batch row a contiguous quarter of the
    item's chunks."""
    if bt > 1:
        return range(r0 + warp, r1, WARPS)
    c0, c1 = r0 // 8, r1 // 8
    q = -(-(c1 - c0) // WARPS)
    k0 = c0 + warp * q
    return range(k0 * 8, max(k0, min(c1, k0 + q)) * 8)


def _k4_replay(r, x, bt, sms):
    """K4's walk in numpy: each item's windows (staged once a block from 2
    batch rows, by each warp from its chunk's ct at one), each warp's rows
    summed in order, a row's window found by counting the item's run
    starts, the warps' sums in warp order, then each group's partials."""
    cj, ct = r.cj.numpy(), r.ct.numpy()
    idx = r.idx.numpy().reshape(-1, 128).astype(np.int64)
    vals = r.vals.numpy().reshape(-1, 128)
    nb = r.padded[1] // 128
    batch, ldx = x.shape
    items, gptr = _plans(cj, ct, nb, sms)[bt]
    w = k4.MAX_WINDOWS[bt]
    nw = (k4.ITEM_INTS + 1) // 2 - 1

    def window(t):
        cols = t * 128 + np.arange(128)
        return np.where(cols < ldx, x[:, np.minimum(cols, ldx - 1)], 0)

    part = []
    for row in items:
        _, r0, r1 = row[:3]
        wins, runs = row[3:3 + w], row[3 + nw:3 + nw + w - 1]
        total = np.zeros((batch, 128), np.float32)
        for warp in range(WARPS):
            acc = np.zeros((batch, 128), np.float32)
            for q in _k4_rows(r0, r1, warp, bt):
                slot = int(np.sum(q // 8 >= runs))
                assert wins[slot] == ct[q // 8]        # the chunk's window
                acc = (acc + vals[q][None, :]
                       * window(wins[slot])[:, idx[q]]).astype(np.float32)
            total = (total + acc).astype(np.float32)
        part.append(total)
    y = np.zeros((batch, nb, 128), np.float32)
    for j in range(nb):
        y[:, j] = _group_sum(part[gptr[j]:gptr[j + 1]], bt, batch)
    return y.reshape(batch, -1)


@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("name", list(PACKS))
def test_k4_replay_gives_the_plain_product(name, batch):
    a = _matrix(*PACKS[name][:5])
    r = RsellMatrix.from_dense(a, device="cpu")
    x = generators.random_sparse_batch(batch, a.shape[0], 0.5, seed=batch)
    x = np.ascontiguousarray(x[:, :a.shape[0] - 3])       # x narrower
    plain = k4.rsell_spmm_plain(r.cj, r.ct, r.idx, r.vals,
                                torch.from_numpy(x), n_padded=r.padded[1])
    bt = batch_tile(batch)
    for sms in (132, 2):          # many small items; a few long ones
        y = _k4_replay(r, x, bt, sms)
        np.testing.assert_allclose(y, plain.numpy(), rtol=0, atol=ATOL_PLAIN)


def _k9_replay(plan, k, a_pad, x, n, cluster):
    """K9's walk in numpy: cluster rank r takes the r-th run of the k * 128
    live plan rows (whole stages of 32), warp w sums rows 8w .. 8w+7 of
    each stage in order, the warps' sums in warp order, then the ranks'
    sums in rank order from 0 (x read as 0 past its width)."""
    batch, ldx = x.shape
    total = min(int(k[0]), len(plan)) * 128
    per = -(-total // (cluster * 32)) * 32
    a = a_pad[:, :n]
    y = np.zeros((batch, n), np.float32)
    for rank in range(cluster):
        r0 = min(total, rank * per)
        r1 = min(total, r0 + per)
        assert (r1 - r0) % 32 == 0
        warps = np.zeros((WARPS, batch, n), np.float32)
        for s0 in range(r0, r1, 32):
            row = int(plan[s0 // 128]) * 128 + s0 % 128
            for warp in range(WARPS):
                for u in range(8 * warp, 8 * warp + 8):
                    xv = x[:, row + u] if row + u < ldx else np.zeros(batch)
                    warps[warp] = (warps[warp] + xv[:, None].astype(np.float32)
                                   * a[row + u][None, :]).astype(np.float32)
        block = np.zeros((batch, n), np.float32)
        for warp in range(WARPS):
            block = (block + warps[warp]).astype(np.float32)
        y = (y + block).astype(np.float32)
    return y


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("shape,block_n", [((300, 200), 2048),
                                           ((200, 301), 301),
                                           ((384, 130), 130)])
def test_k9_replay_gives_the_plain_product(shape, block_n, batch, cluster):
    m, n = shape
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=m + n)
    f = AspMatrix.from_dense(a, block_n=block_n, device="cpu")
    lda = f.a_pad.shape[1]
    assert block_n != 2048 or lda % 4 == 0
    if block_n in (301, 130):
        assert lda % 4 != 0                      # K9's 4-byte copy path
    x = generators.random_sparse_batch(batch, m, 0.5, seed=batch)
    x[:, 128:256] = 0                            # window 1 is dead
    xt = torch.from_numpy(x)
    a_pad = f.a_pad.numpy()
    plans = {"static": torch.from_numpy(f.plan(x)),
             "device": device_group_plan(xt, f.n_units, 128),
             "explicit": torch.tensor([f.n_units, 0], dtype=torch.int32)}
    for what, plan in plans.items():
        if what == "device":
            plan, k = plan
        else:
            k = f._count(plan.numel())
        y = _k9_replay(plan.numpy(), k.numpy(), a_pad, x, n, cluster)
        plain = k9.asp_spmm_plain(plan, k, f.a_pad, xt, n=n)
        np.testing.assert_allclose(y, plain.numpy(), rtol=0, atol=ATOL_PLAIN)
    zero = torch.zeros((batch, m))
    plan, k = device_group_plan(zero, f.n_units, 128)
    assert int(k[0]) == 1 and int(plan[0]) == f.n_units
    assert not _k9_replay(plan.numpy(), k.numpy(), a_pad, zero.numpy(), n,
                          cluster).any()


# ---- against the JAX package ----------------------------------------------

@pytest.fixture(scope="module")
def jax_products():
    """One RSELL product (run-aligned sorted pack, B = 3) and one ASP
    product (m, n off 128, B = 3) of the JAX package, in interpret mode."""
    a_r = _matrix(*PACKS["run"][:5])
    x_r = generators.random_sparse_batch(3, a_r.shape[0], 0.5, seed=21)
    a_s = generators.random_sparse_matrix(300, 200, density=0.5, seed=22)
    x_s = generators.random_sparse_batch(3, 300, 0.5, seed=23)
    x_s[:, :128] = 0
    return {"rsell": (a_r, x_r, np.asarray(JRsell.from_dense(a_r).spmm(x_r))),
            "asp": (a_s, x_s, np.asarray(JAsp.from_dense(a_s).spmm(x_s)))}


def test_k4_replay_matches_jax(jax_products):
    a, x, jy = jax_products["rsell"]
    r = RsellMatrix.from_dense(a, device="cpu")
    y = _k4_replay(r, x, batch_tile(3), 132)
    # the sorted pack's columns, unpermuted as K5 does
    y = y[:, r.inv_perm[:a.shape[1]]]
    np.testing.assert_allclose(y, jy, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(y, reference.sgemm_cpu(x, a), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("cluster", [1, 8])
def test_k9_replay_matches_jax(jax_products, cluster):
    a, x, jy = jax_products["asp"]
    f = AspMatrix.from_dense(a, device="cpu")
    plan = f.plan(x)
    assert 0 not in plan
    y = _k9_replay(plan, np.array([len(plan)]), f.a_pad.numpy(), x,
                   a.shape[1], cluster)
    np.testing.assert_allclose(y, jy, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(y, reference.sgemm_cpu(x, a), rtol=0,
                               atol=1e-3)


# ---- launch shapes and the wrappers' checks --------------------------------

@pytest.mark.parametrize("n,batch,want", [(4096, 1, 4), (4096, 8, 4),
                                          (8192, 8, 2), (8192, 1, 2),
                                          (4096, 9, 2), (200, 3, 8),
                                          (65536, 1, 1), (32768, 8, 1)])
def test_k9_cluster_gives_each_block_an_sm(n, batch, want):
    cluster, strips, tiles = k9.asp_shape(n, batch, H100_SMS)
    assert cluster == want and cluster in k9.CLUSTERS
    assert strips * tiles * cluster <= H100_SMS or cluster == 1
    if cluster < 8:                # a larger cluster would share an SM
        assert strips * tiles * 2 * cluster > H100_SMS
    for sms in (78, 1):
        assert k9.asp_shape(n, batch, sms)[0] in k9.CLUSTERS


@pytest.mark.parametrize("bt", [1, 2, 4, 8])
def test_shared_memory_fits_the_card(bt):
    smem = k9.asp_smem_bytes(bt)
    assert 48 * 1024 < smem <= H100_SMEM           # opted in, under the cap
    assert smem + 1024 <= SM_SMEM                  # a block an SM
    # the ring holds the warps' sums and the block's sum after the loop
    assert smem >= 128 + (4 + 1) * bt * 128 * 4
    need = k4.rsell_smem_bytes(bt)
    assert need <= 48 * 1024                        # no opt-in needed
    assert k4.SHAPES[bt][0] * (need + 1024) <= SM_SMEM
    assert need >= max(k4.MAX_WINDOWS[bt], 4) * bt * 128 * 4
    block_items.check_smem("rsell_spmm", need, H100_SMEM)


@pytest.mark.parametrize("name,first", [("tps_rsell_spmm", ["items", "gptr"]),
                                        ("tps_asp_spmm", ["plan", "count"])])
def test_c_entries_match_their_ctypes_signatures(name, first):
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    assert m, name
    args = [a.strip() for a in m.group(1).split(",") if a.strip()]
    sig = _build._SIGNATURES[name]
    assert len(args) == len(sig)
    for a, t in zip(args, sig):
        assert (t is _build._P) == ("*" in a), (a, t)
    names = [a.split()[-1].lstrip("*") for a in args]
    assert names[:2] == first, names
    assert ("part" in names) == (name == "tps_rsell_spmm")   # K9: no partials


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["rsell", "asp"])
def test_wrappers_off_the_card_raise(name):
    i32 = _meta(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        if name == "rsell":
            k4.rsell_spmm(i32, i32, _meta(2, 8, 128, dtype=torch.int8),
                          _meta(2, 8, 128), _meta(3, 256), n_padded=128,
                          plan={})
        else:
            k9.asp_spmm(i32, _meta(1, dtype=torch.int32), _meta(384, 200),
                        _meta(3, 256), n=200)


@pytest.mark.parametrize("plan", ["old", "narrow"])
def test_k4_refuses_a_foreign_plan(plan):
    """K4 takes only ``rsell_plans``: the earlier (items, gptr) pair or
    items of K6's width raise before any launch."""
    narrow = block_items.ItemPlan(_meta(4, 3, dtype=torch.int32),
                                  _meta(3, dtype=torch.int32))
    given = tuple(narrow) if plan == "old" else {1: narrow}
    with pytest.raises(ValueError, match="plan must be"):
        block_items.resolve("rsell_spmm", given, _meta(4, dtype=torch.int32),
                            2, 8, 1, torch.device("meta"), k4.SHAPES,
                            cols=k4.ITEM_INTS)
