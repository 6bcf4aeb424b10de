"""What the redesigned K6 (``csrc/bsr_spmv.cu``) and K7
(``csrc/bsell_spmv.cu``) rest on, checked on the CPU (no kernel runs here):

- the part-tile work plan (``kernels/block_items.py``): for nblk in {0, 1,
  320, 1024}, several block_m and W, and cards of 132, 78 and 1 SMs, every
  row of every tile lies in exactly one item, the items are sorted by
  group with ``gptr`` consistent, an item is one group's run of rows
  within its size (and K7's within ``MAX_TILES``
  tiles), and the launch covers every batch row once;
- the plan fills the card: about 1,000 items on blockpruned-4096, where
  one item a tile gave 320, and about as many at the headline packs;
- the kernels' fixed-order sums (4 warps a block taking rows w, w+4, ...,
  the warps' sums added in order, then a group's partials added as the
  second kernel adds them at 1-4 and at 8 batch rows), replayed in numpy
  from the plan, give the plain versions' products;
- K7's window tracking (a warp's row as (window, slot), moved on by 4 rows
  without a division) names the right x window;
- the shared-memory budget fits the H100's 227 KB a block and the check
  raises past it; the wrappers' new argument checks (``meta`` tensors reach
  them without a card); the C entries' argument counts.
"""

import re

import numpy as np
import pytest
import torch

from tpusparse_torch.formats import BsrMatrix, TcsrMatrix
from tpusparse_torch.kernels import _build, block_items
from tpusparse_torch.kernels import bsell_spmv as k7
from tpusparse_torch.kernels import bsr_spmv as k6
from tpusparse_torch.kernels.dense import batch_tile
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import cdiv

H100_SMEM = 232448 - 1024      # _build.SMEM_LIMIT
WARPS = 4                      # csrc/sell_common.cuh kWarps
KERNELS = {"K6": (k6.SHAPES, 0), "K7": (k7.SHAPES, k7.MAX_TILES)}


def _groups(nblk: int, nb: int, seed: int) -> np.ndarray:
    """bj of a (bj, bi)-sorted list of nblk tiles over nb groups, some
    groups empty."""
    rng = np.random.default_rng(seed)
    live = rng.random(nb) < 0.8
    live[rng.integers(nb)] = True
    return np.sort(rng.choice(np.flatnonzero(live), nblk)).astype(np.int32)


def _check_plan(items, gptr, bj, nb, tile_rows, per, max_tiles):
    rows = len(bj) * tile_rows
    assert items.dtype == np.int32 and gptr.dtype == np.int32
    assert gptr.shape == (nb + 1,) and gptr[0] == 0
    assert gptr[-1] == len(items)
    assert np.all(np.diff(items[:, 0]) >= 0)             # sorted by group
    for j in range(nb):
        assert np.all(items[gptr[j]:gptr[j + 1], 0] == j)
    seen = np.zeros(rows, np.int32)
    for g, r0, r1 in items:
        assert 0 <= r0 <= r1 <= rows and r1 - r0 <= per
        if r1 > r0:
            tiles = np.arange(r0 // tile_rows, (r1 - 1) // tile_rows + 1)
            assert np.all(bj[tiles] == g)                # one group's run
            if max_tiles:
                assert len(tiles) <= max_tiles
        seen[r0:r1] += 1
    assert np.all(seen == 1)                             # every row once


@pytest.mark.parametrize("sms", [132, 78, 1])
@pytest.mark.parametrize("kernel,tile_rows", [
    ("K6", 8), ("K6", 24), ("K6", 128), ("K6", 512),
    ("K7", 1), ("K7", 8), ("K7", 88), ("K7", 128)])
@pytest.mark.parametrize("nblk", [0, 1, 320, 1024])
def test_plan_covers_every_row_once(nblk, kernel, tile_rows, sms):
    shapes, max_tiles = KERNELS[kernel]
    nb = 32
    bj = _groups(nblk, nb, seed=nblk + tile_rows)
    plans = block_items.plans(bj, nb, tile_rows, sms, shapes, max_tiles)
    assert set(plans) == {1, 2, 4, 8}
    for bt, (items, gptr) in plans.items():
        per = block_items.item_rows(nblk * tile_rows, sms, *shapes[bt])
        if max_tiles:
            per = min(per, (max_tiles - 1) * tile_rows + 1)
        _check_plan(items, gptr, bj, nb, tile_rows, per, max_tiles)
        # the launch: blockIdx.y batch tiles of bt rows cover B once
        for batch in (1, 2, 3, 5, 8, 9, 16, 40):
            if batch_tile(batch) != bt:
                continue
            covered = [z * bt + b for z in range(cdiv(batch, bt))
                       for b in range(bt) if z * bt + b < batch]
            assert covered == list(range(batch))


def test_plan_cuts_unsorted_runs_by_group():
    """Tiles of one group in two runs: each run is cut on its own, and the
    group's items stay together after the sort."""
    bj = np.array([2, 2, 0, 0, 2, 1], np.int32)
    items, gptr = block_items.item_plan(bj, 4, tile_rows=8, per_item=5)
    _check_plan(items, gptr, bj, 4, 8, 5, 0)
    assert list(gptr) == [0, 4, 6, 12, 12]           # group 3: no item


def test_plan_refuses_bad_groups_and_rows():
    with pytest.raises(ValueError, match="groups"):
        block_items.item_plan(np.array([0, 4], np.int32), 4, 8, 8)
    with pytest.raises(ValueError, match="int32"):
        block_items.item_plan(np.zeros(2**22, np.int32), 1, 1024, 8)


@pytest.mark.parametrize("kernel", ["K6", "K7"])
@pytest.mark.parametrize("bt", [1, 2, 4, 8])
def test_plan_fills_the_card_on_blockpruned(kernel, bt):
    """blockpruned-4096: 320 tiles over 32 groups (K6 block_m 128, K7 W 88)
    gave 320 one-tile items; the plan gives about sms x resident items."""
    shapes, max_tiles = KERNELS[kernel]
    a = generators.block_pruned_matrix(4096, 4096, block=128, keep_frac=0.3,
                                       fill=0.5, seed=9)
    nz = a.reshape(32, 128, 32, 128).any(axis=(1, 3))     # (bi, bj) tiles
    bj = np.sort(np.nonzero(nz.T)[0]).astype(np.int32)
    bj = np.r_[bj, np.full(-len(bj) % 8, 31, np.int32)]   # padding tiles
    tile_rows = 128 if kernel == "K6" else 88
    items, _ = block_items.plans(bj, 32, tile_rows, 132, shapes,
                                 max_tiles)[bt]
    slots = 132 * shapes[bt][0]
    assert len(bj) <= 330 and 0.75 * slots <= len(items) <= slots + 32
    if bt <= 2:
        assert len(items) >= 950


@pytest.mark.parametrize("kernel,nblk,tile_rows", [("K6", 256, 512),
                                                   ("K7", 1024, 88)])
def test_plan_at_the_headline_keeps_about_a_wave(kernel, nblk, tile_rows):
    """The headline packs (BSR at block_m 512; TCSR's 1024 tiles of W 88)
    already held ~1,000 tiles: the plan stays near one wave."""
    shapes, max_tiles = KERNELS[kernel]
    bj = np.repeat(np.arange(32, dtype=np.int32), nblk // 32)
    for bt, (items, _) in block_items.plans(bj, 32, tile_rows, 132, shapes,
                                            max_tiles).items():
        slots = 132 * shapes[bt][0]     # each group adds at most one item
        assert 0.75 * slots <= len(items) <= slots + 32, (bt, len(items))


# ---- the kernels' order of work, replayed ----------------------------------

def _block_sum(rows_of_warp, product, batch):
    """One block: each warp sums its rows in order (fp32), then the warps'
    sums are added in warp order."""
    total = np.zeros((batch, 128), np.float32)
    for warp in range(WARPS):
        acc = np.zeros((batch, 128), np.float32)
        for r in rows_of_warp(warp):
            acc = (acc + product(r)).astype(np.float32)
        total = (total + acc).astype(np.float32)
    return total


def _group_sum(parts, bt, batch):
    """A group's partials added as the second kernel adds them
    (``csrc/block_items.cuh``): at 8 batch rows in item order from 0; at
    1-4 by the group reduce of ``work_items.cuh``, 32 slices (slice r adds
    items r, r + 32, ... in order), then the slices in order."""
    zero = np.zeros((batch, 128), np.float32)       # a group with no item
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


def _replay(items, gptr, nb, batch, bt, product):
    """Every item's partial, then each group's partials summed as the
    second kernel sums them."""
    part = [_block_sum(lambda w, r0=r0, r1=r1: range(r0 + w, r1, WARPS),
                       product, batch) for _, r0, r1 in items]
    y = np.zeros((batch, nb, 128), np.float32)
    for j in range(nb):
        y[:, j] = _group_sum(part[gptr[j]:gptr[j + 1]], bt, batch)
    return y.reshape(batch, -1)


def _x(batch, m, ldx, seed):
    x = generators.random_sparse_batch(batch, m, 0.5, seed=seed)
    return np.ascontiguousarray(x[:, :ldx])


@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("block_m,ldx", [(8, 512), (24, 500), (64, 512),
                                         (128, 300)])
def test_k6_replay_gives_the_plain_product(block_m, ldx, batch):
    a = generators.block_pruned_matrix(512, 1024, block=128, keep_frac=0.3,
                                       fill=0.5, seed=3)
    f = BsrMatrix.from_dense(a, block_m=block_m, device="cpu")
    bi, bj = f.bi.numpy(), f.bj.numpy()
    panel = f.blocks.numpy().reshape(-1, 128)
    nb = f.padded[1] // 128
    x = _x(batch, 512, ldx, seed=block_m)

    def product(r):
        col = bi[r // block_m] * block_m + r % block_m
        xv = x[:, col] if col < ldx else np.zeros(batch, np.float32)
        return xv[:, None] * panel[r][None, :]

    for bt, sms in ((1, 132), (8, 3)):    # groups of > 32 items at 132
        items, gptr = block_items.plans(bj, nb, block_m, sms, k6.SHAPES)[bt]
        whole = (items[:, 1] % block_m == 0) & (items[:, 2] % block_m == 0) \
            & (items[:, 2] - items[:, 1] == block_m)
        assert bt == 1 or not np.all(whole)     # items are not the blocks
        y = _replay(items, gptr, nb, batch, bt, product)
        plain = k6.bsr_spmm_plain(f.bi, f.bj, f.blocks, torch.from_numpy(x),
                                  n_padded=f.padded[1])
        np.testing.assert_allclose(y, plain.numpy(), rtol=0, atol=1e-5)


def _sell_tier(kind):
    """(bi, bj, idx, vals, m, n_padded) of a block-SELL tile list: TCSR's
    SELL tier of a block-pruned matrix, or random (bj, bi)-sorted tiles of
    width W (kind "w<W>") over 4 windows and 3 groups, group 1 empty."""
    if kind == "pruned":
        a = generators.block_pruned_matrix(512, 1024, block=128,
                                           keep_frac=0.3, fill=0.5, seed=3)
        f = TcsrMatrix.from_dense(a, expect_batch=1, device="cpu")
        assert f.bsr is None and f.n_sell > 0
        return f.s_bi, f.s_bj, f.idx, f.vals, f.padded[0], f.padded[1]
    w = int(kind[1:])
    rng = np.random.default_rng(w)
    bj = np.sort(rng.choice([0, 2], 11)).astype(np.int32)
    bi = rng.integers(0, 4, 11).astype(np.int32)
    idx = rng.integers(0, 128, (11, w, 128)).astype(np.int8)
    vals = (rng.uniform(-1, 1, (11, w, 128))
            * (rng.random((11, w, 128)) < 0.7)).astype(np.float32)
    return (torch.from_numpy(bi), torch.from_numpy(bj), torch.from_numpy(idx),
            torch.from_numpy(vals), 512, 384)


@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("kind,ldx", [("w1", 512), ("w1", 250),
                                      ("w5", 300), ("pruned", 512),
                                      ("pruned", 300)])
def test_k7_replay_gives_the_plain_product(kind, ldx, batch):
    s_bi, s_bj, s_idx, s_vals, m, n_padded = _sell_tier(kind)
    w = s_vals.shape[1]
    bi, bj = s_bi.numpy(), s_bj.numpy()
    idx = s_idx.numpy().reshape(-1, 128).astype(np.int64)
    vals = s_vals.numpy().reshape(-1, 128)
    nb = n_padded // 128
    x = _x(batch, m, ldx, seed=w)
    xp = np.zeros((batch, m), np.float32)
    xp[:, :ldx] = x

    def product(r):
        return vals[r][None, :] * xp[:, bi[r // w] * 128 + idx[r]]

    for bt, sms in ((1, 132), (8, 3)):
        items, gptr = block_items.plans(bj, nb, w, sms, k7.SHAPES,
                                        k7.MAX_TILES)[bt]
        y = _replay(items, gptr, nb, batch, bt, product)
        plain = k7.bsell_spmm_plain(s_bi, s_bj, s_idx, s_vals,
                                    torch.from_numpy(x), n_padded=n_padded)
        np.testing.assert_allclose(y, plain.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("w", [1, 3, 4, 5, 8, 88, 128])
def test_k7_window_tracking_names_the_tile(w):
    """csrc/bsell_spmv.cu moves a warp's (window, slot) on by kWarps rows
    with subtractions; it must equal (r // w - k0, r % w) at every row."""
    rng = np.random.default_rng(w)
    for _ in range(50):
        r0 = int(rng.integers(0, 40 * w))
        r1 = r0 + int(rng.integers(1, (k7.MAX_TILES - 1) * w + 2))
        k0 = r0 // w
        assert (r1 - 1) // w - k0 + 1 <= k7.MAX_TILES
        for warp in range(WARPS):
            if r0 + warp >= r1:
                continue
            cw = (r0 + warp) // w - k0
            cs = r0 + warp - (cw + k0) * w
            for r in range(r0 + warp, r1, WARPS):
                assert (cw, cs) == (r // w - k0, r % w)
                cs += WARPS
                while cs >= w:
                    cs -= w
                    cw += 1


# ---- budgets and the wrappers' checks --------------------------------------

@pytest.mark.parametrize("bt", [1, 2, 4, 8])
def test_smem_fits_the_card(bt):
    for need in (k6.bsr_smem_bytes(bt), k7.bsell_smem_bytes(bt)):
        assert need <= 48 * 1024 <= H100_SMEM    # no opt-in needed
        block_items.check_smem("k", need, H100_SMEM)
    # the warps' sums and K7's windows fit what the kernels declare
    assert k6.bsr_smem_bytes(bt) >= 4 * bt * 128 * 4
    assert k7.bsell_smem_bytes(bt) >= k7.MAX_TILES * bt * 128 * 4


@pytest.mark.parametrize("need", [H100_SMEM + 1, 256 * 1024])
def test_smem_check_raises_past_the_card(need):
    assert _build.SMEM_LIMIT == H100_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        block_items.check_smem("bsell_spmm", need, _build.SMEM_LIMIT)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_bsr_spmm_refuses_rows_past_int32():
    nblk = 2**17
    with pytest.raises(ValueError, match="int32 row ids"):
        k6.bsr_spmm(_meta(nblk, dtype=torch.int32),
                    _meta(nblk, dtype=torch.int32),
                    _meta(nblk, 2**14 + 8, 128), _meta(2, 64),
                    n_padded=128)


def test_bsell_spmm_refuses_rows_past_int32():
    nblk = 2**24
    with pytest.raises(ValueError, match="int32 row ids"):
        k7.bsell_spmm(_meta(nblk, dtype=torch.int32),
                      _meta(nblk, dtype=torch.int32),
                      _meta(nblk, 128, 128, dtype=torch.int8),
                      _meta(nblk, 128, 128), _meta(2, 64), n_padded=128)


def test_bsell_spmm_refuses_zero_width_tiles():
    with pytest.raises(ValueError, match="bsell_spmm"):
        k7.bsell_spmm(_meta(2, dtype=torch.int32), _meta(2, dtype=torch.int32),
                      _meta(2, 0, 128, dtype=torch.int8), _meta(2, 0, 128),
                      _meta(2, 64), n_padded=128)


@pytest.mark.parametrize("name", ["bsr", "bsell"])
def test_wrappers_off_the_card_raise(name):
    """A tensor on no CUDA device (here ``meta``) is refused, never run
    through the plain version."""
    i32 = _meta(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        if name == "bsr":
            k6.bsr_spmm(i32, i32, _meta(2, 8, 128), _meta(3, 16),
                        n_padded=128)
        else:
            k7.bsell_spmm(i32, i32, _meta(2, 8, 128, dtype=torch.int8),
                          _meta(2, 8, 128), _meta(3, 256), n_padded=128)


@pytest.mark.parametrize("plan", [
    "old", "no_tile", lambda p: {1: p._replace(gptr=_meta(4, dtype=torch.int32))},
    lambda p: {1: p._replace(items=_meta(4, 3, dtype=torch.int64))},
    lambda p: {1: p._replace(items=_meta(4, 2, dtype=torch.int32))}])
def test_resolve_refuses_a_foreign_plan(plan):
    """The wrappers take only the ``device_plans`` of the pack: the old
    (items, gptr) pair, a dict without the batch tile, or tensors of the
    wrong type or size raise before any launch."""
    good = block_items.ItemPlan(_meta(4, 3, dtype=torch.int32),
                                _meta(3, dtype=torch.int32))
    if plan == "old":
        plan = tuple(good)
    elif plan == "no_tile":
        plan = {8: good}
    else:
        plan = plan(good)
    with pytest.raises(ValueError, match="plan must be"):
        block_items.resolve("bsr_spmm", plan, _meta(4, dtype=torch.int32), 2,
                            128, 1, torch.device("meta"), k6.SHAPES)


@pytest.mark.parametrize("name", ["tps_bsr_spmm", "tps_bsell_spmm"])
def test_c_entries_match_their_ctypes_signatures(name):
    """The redesigned entries take the work plan (items, gptr) first and
    as many arguments, pointers where pointers, as the ctypes signature
    the loader gives them (a mismatch only shows on the card)."""
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    assert m, name
    args = [a.strip() for a in m.group(1).split(",") if a.strip()]
    sig = _build._SIGNATURES[name]
    assert len(args) == len(sig)
    for a, t in zip(args, sig):
        assert (t is _build._P) == ("*" in a), (a, t)
    names = [a.split()[-1].lstrip("*") for a in args]
    assert names[:2] == ["items", "gptr"] and "nitems" in names, names
