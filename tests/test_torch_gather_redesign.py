"""What the redesigned K1 (``csrc/sell_spmv.cu``) and K12
(``csrc/bell_spmv.cu``) rest on, checked on the CPU (no kernel runs here):

- the launch shapes (``sell_shape``, ``bell_shape``): every (column group,
  window, batch row) of K1 and every (group, contraction block, column,
  batch row) of K12 is covered exactly once, for a grid of shapes and
  B in {1, 3, 8, 9, 32, 40}, and the blocks fill the card in one wave;
- the shared-memory budget: every shape the wrappers accept fits the
  H100's 227 KB a block, and the check raises past it;
- K1's ring-kernel lane map covers each block's columns and batch rows once
  a row group, and at 32 rows a quarter warp reads one row of x;
- the kernels' schedules, replayed in numpy (K1's row groups, K12's
  per-warp column order, the fixed-order sums), give the plain versions'
  products;
- K12's decode (a ballot over 32 positions a step of the interleaved bit
  order) lists the live positions in rank order, and its transposing
  butterfly leaves each batch row's sum in its own lane;
- the wrappers' new argument checks (``meta`` tensors reach them without a
  card).
"""

import numpy as np
import pytest
import torch

from tpusparse_torch.formats import BellMatrix, SellMatrix
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.bell_spmv import (BellShape, bell_shape,
                                               bell_smem_bytes, bell_spmm,
                                               bell_spmm_plain, expand_mask)
from tpusparse_torch.kernels.sell_spmv import (SellShape, sell_shape,
                                               sell_smem_bytes, sell_spmm,
                                               sell_spmm_plain,
                                               x_window_floats)
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import cdiv

H100_SMS = 132
H100_SMEM = 232448 - 1024      # _build.SMEM_LIMIT
H100_SM = 233472               # an SM's shared memory (_build.SM_SMEM)
BATCHES = [1, 3, 8, 9, 32, 40]


def test_smem_limit_is_the_h100s():
    assert (_build.SMEM_LIMIT, _build.SM_SMEM) == (H100_SMEM, H100_SM)


# ---- K1 -------------------------------------------------------------------

def k1_blocks(shape: SellShape, nb: int, nt: int, batch: int):
    """Yield (j, slice, windows, batch rows) of each block."""
    for j in range(nb):
        for k in range(shape.slices):
            t0 = k * shape.per_slice
            wins = range(t0, min(nt, t0 + shape.per_slice))
            for z in range(shape.nz):
                rows = [b for b in range(z * shape.bb, (z + 1) * shape.bb)
                        if b < batch]
                yield j, k, list(wins), rows


def k1_lanes(bb: int, warps: int = 8):
    """csrc/sell_spmv.cu's ring-kernel lane map (16 or 32 rows): for each of
    the block's warps' 32 lanes, (row group, first column, first batch row,
    batch rows); and the row groups. The bb/4 lanes of a column quad take
    its batch quads."""
    nq = bb // 4
    out = []
    for warp in range(warps):
        for lane in range(32):
            quad = (warp % nq) * (32 // nq) + lane // nq
            out.append((warp // nq, 4 * quad, (lane % nq) * 4, 4))
    return out, warps // nq


def k1_row_groups(shape: SellShape) -> int:
    """Row groups a K1 block splits a tile's slot rows into: the 4 warps of
    the 128-thread kernel, or the ring kernel's."""
    return 4 if shape.bb <= 8 else k1_lanes(shape.bb, 8)[1]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("nb,nt,w,itemsize", [(32, 32, 88, 4), (32, 32, 32, 4),
                                              (64, 64, 24, 4), (3, 2, 8, 2),
                                              (1, 1, 8, 1), (200, 7, 128, 4),
                                              (2, 40, 16, 4)])
@pytest.mark.parametrize("sms", [H100_SMS, 1])
def test_sell_shape_covers_every_window_and_row_once(nb, nt, w, itemsize,
                                                     batch, sms):
    shape = sell_shape(nb, nt, w, batch, itemsize, sms)
    assert shape.bb in (1, 2, 4, 8, 16, 32)
    assert shape.nz == cdiv(batch, shape.bb)
    if shape.bb <= 8:                        # the 128-thread kernel
        assert shape.nz == 1 and shape.smem == 0
        want = max(1, min(nt, cdiv(8 * sms, nb)))
        assert shape.per_slice == cdiv(nt, want)
    else:
        assert 1 <= shape.stages <= 2
        assert shape.resident in (1, 2)
        assert shape.smem == sell_smem_bytes(w, itemsize, shape.bb,
                                             shape.stages)
        assert shape.smem <= H100_SMEM
        assert shape.resident * (shape.smem + 1024) <= H100_SM
        slots = shape.resident * sms             # one wave
        if nb * shape.nz <= slots:
            assert nb * shape.nz * shape.slices <= slots
    seen = np.zeros((nb, nt, batch), np.int64)
    for j, k, wins, rows in k1_blocks(shape, nb, nt, batch):
        assert wins, (j, k)                  # no empty slice
        for t in wins:
            seen[j, t, rows] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("batch,bb", [(1, 1), (2, 2), (3, 4), (8, 8), (9, 16),
                                      (16, 16), (17, 32), (32, 32), (40, 32)])
def test_sell_shape_batch_block(batch, bb):
    """Up to 8 rows a batch tile of 1, 2, 4 or 8; then 16 or 32 rows a
    block."""
    assert sell_shape(32, 32, 88, batch, 4, H100_SMS).bb == bb


def test_sell_shape_reads_the_pack_once_up_to_32_rows():
    """At the floors study's B = 32, one block down the batch: the pack is
    streamed once, not four times as with 8-row blocks."""
    for batch in (1, 8, 32):
        assert sell_shape(32, 32, 88, batch, 4, H100_SMS).nz == 1
    assert sell_shape(32, 32, 88, 40, 4, H100_SMS).nz == 2


@pytest.mark.parametrize("bb", [16, 32])
def test_k1_lanes_cover_the_block_once(bb):
    """Each row group's lanes own every (column, batch row) of the block
    once; at 32 rows the 8 lanes of each quarter warp share one column and
    read the 8 16-byte pieces of one row of x: every bank once."""
    lanes, rgroups = k1_lanes(bb, 8)
    seen = np.zeros((rgroups, 128, bb), np.int64)
    for rg, c0, b0, bl in lanes:
        seen[rg, c0:c0 + 4, b0:b0 + bl] += 1
    assert (seen == 1).all()
    if bb == 32:
        for q0 in range(0, len(lanes), 8):
            quarter = lanes[q0:q0 + 8]
            assert len({c0 for _, c0, _, _ in quarter}) == 1
            assert sorted(b0 for _, _, b0, _ in quarter) == list(range(0, 32, 4))


@pytest.mark.parametrize("bb", [16, 32])
def test_x_stride_spreads_nearby_offsets_over_the_banks(bb):
    """The transposed x window's rows hold bb + 4 floats, an odd number of
    16-byte units: 8 consecutive offsets fall in 8 distinct 16-byte bank
    groups, and the 128 threads storing one batch quad of 128 consecutive
    columns (16 bytes each) write each group of 8 in distinct banks."""
    units = x_window_floats(bb) // 128 // 4
    assert units % 2 == 1
    for o in range(0, 128, 8):
        assert len({((o + u) * units) % 8 for u in range(8)}) == 8


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("batch", BATCHES)
def test_sell_smem_fits_every_window_width(itemsize, batch):
    """Every SELL tile (W <= 128: a column has at most 128 offsets a window)
    fits the ring kernel with two stages."""
    for w in range(8, 129, 8):
        shape = sell_shape(32, 32, w, batch, itemsize, H100_SMS)
        assert shape.bb <= 8 or shape.stages == 2, (w, shape)
        assert shape.smem <= H100_SMEM


def test_sell_smem_check_raises_past_the_card():
    # W = 400 (only repeated CSR entries give W > 128): one fp32 stage is
    # 250 KB, over the 227 KB a block may have
    with pytest.raises(ValueError, match="shared memory"):
        sell_shape(32, 32, 400, 32, 4, H100_SMS)
    with pytest.raises(ValueError, match="shared memory"):
        sell_shape(32, 32, 128, 16, 4, H100_SMS, smem_limit=48 * 1024)
    shape = sell_shape(32, 32, 176, 32, 4, H100_SMS)  # one stage only
    assert shape.stages == 1 and shape.smem <= H100_SMEM
    assert sell_shape(32, 32, 400, 8, 4, H100_SMS).smem == 0   # no ring


def replay_k1(idx, vals, x, n, sms):
    """The CUDA K1's arithmetic in its order, in float32: per block and row
    group (a warp of the 128-thread kernel, or the ring kernel's), slot rows
    r = rg, rg + R, ... of each window of the run; row groups added in
    order; slices added in order."""
    nb, nt, w, _ = vals.shape
    batch = x.shape[0]
    shape = sell_shape(nb, nt, w, batch, 4, sms)
    rgroups = k1_row_groups(shape)
    xp = np.zeros((batch, nt * 128), np.float32)
    xp[:, :x.shape[1]] = x
    part = np.zeros((shape.slices, batch, nb * 128), np.float32)
    for j, k, wins, rows in k1_blocks(shape, nb, nt, batch):
        acc = np.zeros((rgroups, len(rows), 128), np.float32)
        for t in wins:
            for rg in range(rgroups):
                for r in range(rg, w, rgroups):
                    xv = xp[np.ix_(rows, t * 128 + idx[j, t, r].astype(int))]
                    acc[rg] = acc[rg] + vals[j, t, r] * xv
        s = np.zeros((len(rows), 128), np.float32)
        for rg in range(rgroups):
            s = s + acc[rg]
        part[k, rows, j * 128:(j + 1) * 128] = s
    y = np.zeros((batch, nb * 128), np.float32)
    for k in range(shape.slices):
        y = y + part[k]
    return y[:, :n]


@pytest.mark.parametrize("batch", [1, 3, 9, 40])
def test_k1_schedule_gives_the_plain_product(batch):
    a = generators.random_sparse_matrix(300, 260, density=0.3, seed=batch)
    x = generators.random_sparse_batch(batch, 290, 0.5, seed=batch)  # ldx < m
    f = SellMatrix.from_dense(a, device="cpu")
    want = sell_spmm_plain(f.idx, f.vals, torch.from_numpy(x), n=260).numpy()
    got = replay_k1(f.idx.numpy(), f.vals.numpy(), x, 260, sms=3)
    assert np.abs(got - want).max() <= 1e-5


# ---- K12 ------------------------------------------------------------------

def k12_items(shape: BellShape, nb: int, mb: int, batch: int):
    """Yield (j, slice, z, warp, i, column, batch rows) in the order each
    warp of each block (half a group: 64 columns) takes its columns."""
    for j in range(nb):
        for half in range(2):
            for k in range(shape.slices):
                i0 = k * shape.per_slice
                count = max(0, min(mb, i0 + shape.per_slice) - i0)
                for z in range(shape.nz):
                    rows = [b for b in range(z * shape.bb, (z + 1) * shape.bb)
                            if b < batch]
                    for warp in range(8):
                        for q in range(count * 8):
                            yield (j, k, z, warp, i0 + q // 8,
                                   64 * half + warp + 8 * (q % 8), rows)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("nb,mb,block_m,w", [(32, 8, 512, 384), (6, 8, 128, 128),
                                             (3, 1, 1024, 1024), (2, 4, 256, 256),
                                             (64, 16, 512, 256), (1, 3, 32, 128)])
@pytest.mark.parametrize("sms", [H100_SMS, 1])
def test_bell_shape_covers_every_column_once(nb, mb, block_m, w, batch, sms):
    shape = bell_shape(nb, mb, block_m, w, batch, sms)
    assert shape.bb in (1, 2, 4, 8, 16, 32)
    assert shape.nz == cdiv(batch, shape.bb)
    assert shape.counters == 2 * nb * shape.nz
    assert shape.smem == bell_smem_bytes(block_m, w, shape.bb,
                                         shape.per_slice) <= H100_SMEM
    assert 1 <= shape.resident <= 3
    assert shape.resident * (shape.smem + 1024) <= H100_SM
    seen = np.zeros((nb, mb, 128, batch), np.int64)
    for j, _, _, _, i, c, rows in k12_items(shape, nb, mb, batch):
        seen[j, i, c, rows] += 1
    assert (seen == 1).all()
    def waves(per):
        smem = bell_smem_bytes(block_m, w, shape.bb, per)
        res = max(1, min(3, H100_SM // (smem + 1024)))
        return cdiv(2 * nb * shape.nz * cdiv(mb, per), res * sms)

    fits = [p for p in range(1, mb + 1)
            if bell_smem_bytes(block_m, w, shape.bb, p) <= H100_SMEM]
    assert waves(shape.per_slice) == min(waves(p) for p in fits)


def test_bell_shape_at_the_headline():
    """4096^2, block_m 512, W 384: all of B = 8 in one block, runs of two
    contraction blocks: 256 blocks, two an SM, one wave on 132 SMs."""
    shape = bell_shape(32, 8, 512, 384, 8, H100_SMS)
    assert (shape.bb, shape.nz, shape.per_slice, shape.slices,
            shape.resident) == (8, 1, 2, 4, 2)


@pytest.mark.parametrize("block_m", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("batch", [1, 3, 8, 9, 32])
def test_bell_smem_fits_every_accepted_shape(block_m, batch):
    for w in (4, 128, 512, 1024):
        shape = bell_shape(32, 4, block_m, w, batch, H100_SMS)
        assert shape.smem <= H100_SMEM
        assert shape.bb >= min(batch, 8), (w, shape)


def test_bell_smem_check_raises_past_the_card():
    with pytest.raises(ValueError, match="shared memory"):
        bell_shape(32, 4, 1024, 1024, 1, H100_SMS, smem_limit=100 * 1024)
    # the batch rows a block shrink before anything raises
    assert bell_shape(32, 4, 1024, 1024, 32, H100_SMS).bb == 16


def decode_column(words: np.ndarray, block_m: int) -> tuple[list, int]:
    """The kernel's decode of one column: 32 positions a step, position
    l = l0 + lane in word l % nwords at bit l // nwords; a lane's rank is
    the popcount of the step's ballot below it. Returns the sorted
    positions (pads to a multiple of 4 at position 0, as the 1-2 row path
    writes them) and the count."""
    nwords = block_m // 32
    out = np.full(block_m + 8, -1, np.int64)
    cnt = 0
    for l0 in range(0, block_m, 32):
        lanes = np.arange(32)
        l = l0 + lanes
        on = (words[l % nwords].astype(np.int64) >> (l // nwords)) & 1
        ranks = np.cumsum(on) - on
        out[cnt + ranks[on == 1]] = l[on == 1]
        cnt += int(on.sum())
    pad = ((cnt + 3) & ~3) - cnt
    out[cnt:cnt + pad] = 0
    return list(out[:cnt + pad]), cnt


@pytest.mark.parametrize("block_m", [32, 96, 128, 512, 1024])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_decode_lists_live_positions_in_rank_order(block_m, density):
    rng = np.random.default_rng(block_m)
    mask = rng.uniform(size=(16, block_m)) < density
    nwords = block_m // 32
    pos = np.arange(block_m)
    words = np.zeros((16, nwords), np.int64)
    for w_ in range(nwords):
        sel = pos % nwords == w_
        words[:, w_] = (mask[:, sel].astype(np.int64)
                        << (pos[sel] // nwords)).sum(axis=1)
    words32 = words.astype(np.uint32).view(np.int32)
    back = expand_mask(torch.from_numpy(words32), block_m).numpy()
    assert (back == mask).all()              # the packer's bit order
    for r in range(16):
        lst, cnt = decode_column(words32[r].view(np.uint32), block_m)
        assert cnt == int(mask[r].sum())
        assert lst[:cnt] == list(np.nonzero(mask[r])[0])
        assert len(lst) % 4 == 0 and all(v == 0 for v in lst[cnt:])


def transpose_sum(vals: np.ndarray, nq: int = 1) -> np.ndarray:
    """csrc/bell_spmv.cu transpose_sum on 32 lanes x V values (float32):
    returns what each lane holds at the end."""
    v = vals.astype(np.float32).copy()           # (32, V)
    lanes = np.arange(32)
    nv = v.shape[1]
    off, h = 16, nv // 2
    while h >= 1:
        upper = (lanes & off) != 0
        keep = np.where(upper[:, None], v[:, h:2 * h], v[:, :h])
        send = np.where(upper[:, None], v[:, :h], v[:, h:2 * h])
        v = (keep + send[lanes ^ off]).astype(np.float32)
        off //= 2
        h //= 2
    s = v[:, 0]
    o = 16 // nv
    while o >= nq:
        s = (s + s[lanes ^ o]).astype(np.float32)
        o //= 2
    return s


@pytest.mark.parametrize("nv,nq", [(1, 1), (2, 1), (4, 1), (8, 1), (8, 2),
                                   (8, 4)])
def test_transpose_sum_leaves_row_in_its_lane(nv, nq):
    """Value r of the lanes sharing lane % nq ends in lanes with lane / (32
    / nv) == r: the row bq * nv + r of the kernel's batch quad bq."""
    rng = np.random.default_rng(nv * 10 + nq)
    vals = rng.uniform(-1, 1, (32, nv)).astype(np.float32)
    got = transpose_sum(vals, nq)
    lanes = np.arange(32)
    for lane in range(32):
        group = lanes % nq == lane % nq
        want = vals[group].astype(np.float64).sum(axis=0)
        assert abs(got[lane] - want[lane // (32 // nv)]) <= 1e-5
    assert np.array_equal(got, transpose_sum(vals, nq))   # a fixed tree


def replay_k12(bitmap, vals, x, block_m, n, sms):
    """The CUDA K12's arithmetic in its order (float32): each warp's
    columns in turn; at 1-2 rows lane q takes live values 4q .. 4q+3,
    4q+128 ..; from 4 rows the nq = bb/V lanes of a live value take its
    batch rows, V = min(bb, 8) each, lane kk of a group live values kk,
    kk + 32/nq, ...; the
    sums by the transposing butterfly; the block's sums added over its
    contraction blocks in order; slices added in order."""
    nb, mb, _, w = vals.shape
    batch = x.shape[0]
    shape = bell_shape(nb, mb, block_m, w, batch, sms)
    nv = min(8, shape.bb)
    nq = shape.bb // nv
    xp = np.zeros((batch, mb * block_m), np.float32)
    xp[:, :x.shape[1]] = x
    red = {}
    lanes = np.arange(32)
    for j, k, z, _, i, c, rows in k12_items(shape, nb, mb, batch):
        lst, cnt = decode_column(bitmap[j, i, c].view(np.uint32), block_m)
        xz = np.zeros((shape.bb, block_m), np.float32)
        xz[:len(rows)] = xp[rows, i * block_m:(i + 1) * block_m]
        acc = np.zeros((32, nv), np.float32)
        for lane in lanes:
            bq = lane % nq
            if nv <= 2:          # 4 consecutive values a lane, pads 0
                order = [4 * k4 + e for k4 in range(lane, cdiv(cnt, 4), 32)
                         for e in range(4)]
            else:
                order = range(lane // nq, cnt, 32 // nq)
            for kv in order:
                xs = xz[bq * nv:(bq + 1) * nv, lst[kv]]
                acc[lane] = (acc[lane] + vals[j, i, c, kv] * xs) \
                    .astype(np.float32)
        s = transpose_sum(acc, nq)
        for lane in lanes:
            bq = lane % nq
            row = bq * nv + lane // (32 // nv)
            if (lane & (32 // nv - 1)) == bq and row < len(rows):
                key = (k, rows[row], j * 128 + c)
                red[key] = np.float32(red.get(key, 0) + s[lane])
    y = np.zeros((batch, nb * 128), np.float32)
    for k in range(shape.slices):
        for (kk, b, col), v in red.items():
            if kk == k:
                y[b, col] = np.float32(y[b, col] + v)
    return y[:, :n]


@pytest.mark.parametrize("batch", [1, 3, 9, 32])
def test_k12_schedule_gives_the_plain_product(batch):
    a = generators.random_sparse_matrix(300, 140, density=0.3, seed=batch)
    f = BellMatrix.from_dense(a, block_m=128, device="cpu")
    x = generators.random_sparse_batch(batch, 290, 0.5, seed=batch)
    want = bell_spmm_plain(f.bitmap, f.vals, torch.from_numpy(x),
                           block_m=128, n=140).numpy()
    got = replay_k12(f.bitmap.numpy(), f.vals.numpy(), x, 128, 140, sms=2)
    assert np.abs(got - want).max() <= 1e-5


# ---- the wrappers' checks ---------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("n", [-1, 257])
def test_sell_spmm_checks_n(n):
    idx, vals = _meta(2, 3, 8, 128, dtype=torch.int8), _meta(2, 3, 8, 128)
    with pytest.raises(ValueError, match="outside"):
        sell_spmm(idx, vals, _meta(4, 384), n=n)


def test_sell_spmm_off_the_card_raises():
    """A tensor on no CUDA device (here ``meta``) is refused, never run
    through the plain version."""
    idx, vals = _meta(2, 3, 8, 128, dtype=torch.int8), _meta(2, 3, 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        sell_spmm(idx, vals, _meta(4, 384), n=200)


@pytest.mark.parametrize("n", [-1, 257])
def test_bell_spmm_checks_n(n):
    bitmap = _meta(2, 3, 128, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        bell_spmm(bitmap, _meta(2, 3, 128, 128), _meta(4, 384), block_m=128,
                  n=n)


@pytest.mark.parametrize("block_m,w", [(2048, 128), (128, 2048), (128, 6),
                                       (128, 0)])
def test_bell_spmm_checks_block_m_and_w(block_m, w):
    bitmap = _meta(2, 3, 128, block_m // 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="out of range"):
        bell_spmm(bitmap, _meta(2, 3, 128, w), _meta(4, 3 * block_m),
                  block_m=block_m)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_entries_match_their_ctypes_signatures(name):
    """Each C entry in csrc/ takes as many arguments as the ctypes
    signature the loader gives it (a mismatch only shows on the card)."""
    import re
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    assert m, name
    args = [a for a in m.group(1).split(",") if a.strip()]
    assert len(args) == len(_build._SIGNATURES[name])
    pointers = [i for i, a in enumerate(args) if "*" in a]
    assert all(_build._SIGNATURES[name][i] is _build._P for i in pointers)
