"""What the redesigned K3 (``csrc/awsp_spmv.cu``), its plan kernel
(``csrc/group_plan.cu``), K4's fused unpermute (``csrc/work_items.cuh``,
``csrc/block_items.cuh``) and K5's parts form (``csrc/permute.cu``) rest
on, checked on the CPU (no kernel runs here):

- a numpy replay of K3's walk gives the plain product (1e-5) and the JAX
  package's K3 in interpret mode (1e-4) at live 0, 1/16, 1/4 and 1, g in
  {1, 2, 8}, B in {1, 3, 9}, fp32 and bf16 values, x narrower than the
  packed rows: the device split of the k*G*W live slot rows into parts of
  a multiple of 4 rows (``live_parts``), each part's stages (up to 32
  rows of one tile), warp w taking a stage's rows w, w + 4, ..., the warps'
  sums in order, then the parts' sums in order 0 .. parts-1, at several
  slice counts, more than the live rows need among them;
- a replay of the plan kernel (each block tests a chunk of one group's
  columns and batch rows, the last block compacts the flags 256 at a time
  by warp ballots) equals ``device_group_plan_plain`` and the JAX
  ``device_group_plan`` bit for bit;
- a replay of K4's second pass through an ``Unpermute`` (the pack's
  columns summed in pack order, as the group reduce does at 1-4 batch rows
  and one thread an output at 8, each written to its place) equals
  ``permute_columns_plain`` of ``rsell_spmm_plain`` (1e-5), dead lanes 0,
  on a run-aligned, a flat and a selecting-gather pack;
- K5's parts form equals ``permute_columns_plain`` of the concatenation
  exactly;
- the C entries' argument counts match their ctypes signatures; off the
  card the new wrappers raise.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.formats.awsp import AwspMatrix as JAwsp
from tpusparse.kernels.awsp_spmv import device_group_plan as jplan
from tpusparse_torch.formats import AwspMatrix, RsellMatrix
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels import awsp_spmv as k3
from tpusparse_torch.kernels import rsell_spmv as k4
from tpusparse_torch.kernels.dense import batch_tile
from tpusparse_torch.kernels.permute import (MAX_PARTS, permute_columns,
                                             permute_columns_plain)
from tpusparse_torch.testing import generators, reference

ATOL_PLAIN = 1e-5
ATOL_JAX = 1e-4
WARPS = 4                  # csrc/awsp_spmv.cu kAwspWarps
STAGE_ROWS = 32            # kAwspRows
PLAN_THREADS = 256         # csrc/group_plan.cu kPlanThreads
PLAN_CHUNK = 1024          # kPlanChunk
H100_SMS = 132
M, N = 2048, 200           # the K3 matrix: 16 windows, two column groups


def _matrix(seed=50):
    return generators.random_sparse_matrix(M, N, density=0.1, seed=seed)


def _live_x(m, g, live, batch, seed):
    """(batch, m): live in max(1, round(live * ng)) of the ng groups of
    g*128 rows (none for live 0), the pattern shared by the batch rows."""
    ng = -(-m // (g * 128))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (batch, m)).astype(np.float32)
    x *= rng.uniform(size=x.shape) < 0.5
    mask = np.zeros(ng * g * 128, bool)
    if live:
        for gi in rng.choice(ng, max(1, round(live * ng)), replace=False):
            mask[gi * g * 128:(gi + 1) * g * 128] = True
    return np.where(mask[:m], x, 0).astype(np.float32)


# ---- K3's walk, replayed ---------------------------------------------------

def _k3_replay(plan, k, idx, vals, x, g, n, slices):
    """y (B, n) as the kernel sums it: every column group and batch row at
    once (the split does not depend on them)."""
    nb, ntot, w, _ = vals.shape
    v = vals.astype(np.float32)
    batch = x.shape[0]
    xp = np.zeros((batch, ntot * 128), np.float32)
    xp[:, :x.shape[1]] = x
    live = max(0, min(int(k), len(plan))) * g * w
    per, parts = k3.live_parts(live, slices)
    assert parts <= slices and per % k3.QUANTUM == 0
    total = np.zeros((batch, nb, 128), np.float32)
    covered = 0
    for s in range(parts):
        r0, r1 = s * per, min(live, (s + 1) * per)
        covered += max(0, r1 - r0)
        acc = np.zeros((WARPS, batch, nb, 128), np.float32)
        c = r0
        while c < r1:
            e = min(r1, (c // w + 1) * w, c + STAGE_ROWS)
            i = c // w
            t = plan[i // g] * g + i % g
            xw = xp[:, t * 128:(t + 1) * 128]                  # (B, 128)
            for q in range(e - c):
                s_row = c - i * w + q
                off = idx[:, t, s_row, :].astype(np.int64)     # (nb, 128)
                prod = v[:, t, s_row, :][None] * xw[:, off]     # (B, nb, 128)
                acc[q % WARPS] = (acc[q % WARPS] + prod).astype(np.float32)
            c = e
        block = np.zeros((batch, nb, 128), np.float32)
        for wp in range(WARPS):                     # the warps' sums in order
            block = (block + acc[wp]).astype(np.float32)
        total = (total + block).astype(np.float32)  # the parts in order
    assert covered == live                          # every live row once
    return total.reshape(batch, nb * 128)[:, :n]


@pytest.fixture(scope="module")
def awsp_cases():
    """For each g and value type: the port's pack, the JAX pack, and the
    JAX K3's outputs (interpret mode, through ``AwspMatrix.spmm`` with its
    host plan) at B = 3 on each live fraction's X, x narrower than the
    packed rows."""
    a = _matrix()
    out = {}
    for g in (1, 2, 8):
        for dtype in (None, "bfloat16"):
            t = AwspMatrix.from_dense(a, g=g, dtype=dtype, device="cpu")
            jax_y = {}
            if dtype is None or g == 2:
                j = JAwsp.from_dense(a, g=g, dtype=dtype)
                for live in (0.0, 0.0625, 0.25, 1.0):
                    x = _live_x(M - 5, g, live, 3, seed=int(live * 16) + g)
                    xp = np.pad(x, ((0, 0), (0, 5)))   # JAX's plan wants m
                    jax_y[live] = np.asarray(j.spmm(jnp.asarray(xp)))
            out[g, dtype] = (t, jax_y)
    return a, out


@pytest.mark.parametrize("slices", [None, 1, 3, 7, 64])
@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("live", [0.0, 0.0625, 0.25, 1.0])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_k3_walk_gives_the_plain_product(awsp_cases, g, live, batch, slices):
    _, packs = awsp_cases
    for dtype in (None, "bfloat16"):
        t, _ = packs[g, dtype]
        x = _live_x(M - 5, g, live, batch, seed=int(live * 16) + g)
        plan = t.plan(x)
        k = np.int32(len(plan))
        bt = batch_tile(batch)
        s = slices or k3.awsp_slices(
            t.vals.shape[0], -(-batch // bt), len(plan) * g * t.w, bt,
            t.vals.element_size(), H100_SMS)
        vals = t.vals.float().numpy()
        y = _k3_replay(plan, k, t.idx.numpy(), vals, x, g, N, s)
        xt = torch.from_numpy(x)
        want = k3.awsp_spmm_plain(torch.from_numpy(plan),
                                  torch.tensor([k]), t.idx, t.vals, xt,
                                  g=g, n=N)
        np.testing.assert_allclose(y, want.numpy(), rtol=0, atol=ATOL_PLAIN)
        if live == 0.0:
            assert not np.any(y)


@pytest.mark.parametrize("live", [0.0, 0.0625, 0.25, 1.0])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_k3_walk_matches_jax(awsp_cases, g, live):
    """The replay against the JAX K3 (interpret mode) and the oracle, with
    the device plan the plan kernel builds (the JAX device plan's, too)."""
    a, packs = awsp_cases
    for dtype in (None, "bfloat16"):
        t, jax_y = packs[g, dtype]
        if live not in jax_y:
            continue
        x = _live_x(M - 5, g, live, 3, seed=int(live * 16) + g)
        plan, k = _plan_replay(x, t.n_groups, t.span)
        y = _k3_replay(plan, k, t.idx.numpy(), t.vals.float().numpy(), x, g,
                       N, 12)
        np.testing.assert_allclose(y, jax_y[live], rtol=0, atol=ATOL_JAX)
        dense = t.to_dense().float().numpy()
        np.testing.assert_allclose(
            y, reference.sgemm_cpu(np.pad(x, ((0, 0), (0, 5))), dense),
            rtol=0, atol=1e-3)


@pytest.mark.parametrize("sms", [132, 78, 1])
@pytest.mark.parametrize("bt,itemsize", [(1, 4), (8, 4), (4, 2)])
def test_k3_slices_fill_the_card_once(bt, itemsize, sms):
    """The grid fits the card's resident blocks once (three an SM at 8
    batch rows, two at 1-4, as the shared memory allows), each part at least
    QUANTUM rows; live_parts covers the live rows once in at most that
    many parts."""
    smem = k3.awsp_smem_bytes(bt, itemsize)
    resident = min({1: 2, 2: 2, 4: 2, 8: 3}[bt],
                   _build.SM_SMEM // (smem + 1024 + 1024))
    assert smem + 1024 <= _build.SMEM_LIMIT + 1024
    for nb, tiles, rows in ((32, 1, 2560), (2, 3, 40), (64, 2, 8)):
        s = k3.awsp_slices(nb, tiles, rows, bt, itemsize, sms)
        assert 1 <= s <= max(1, -(-rows // k3.QUANTUM))
        assert nb * tiles * s <= max(resident * sms, nb * tiles)
        for live in (0, 1, 4, 37, rows):
            per, parts = k3.live_parts(live, s)
            assert 1 <= parts <= s
            assert per % k3.QUANTUM == 0 and (live == 0 or per > 0)
            assert min(live, parts * per) == live and \
                (parts - 1) * per < max(live, 1)


# ---- the plan kernel, replayed ---------------------------------------------

def _plan_replay(x, ng, span):
    """(plan, k) as group_plan.cu builds them: per-chunk flags, then the
    last block's compaction, 256 flags at a time, each warp's live ids
    placed after the earlier warps' by ballot counts."""
    batch, ldx = x.shape
    per = max(1, -(-batch * span // PLAN_CHUNK))
    flags = np.zeros(ng, np.int32)
    for blk in range(per * ng):
        grp, piece = divmod(blk, per)
        c0 = grp * span
        width = max(0, min(c0 + span, ldx) - c0)
        e0 = min(piece * PLAN_CHUNK, batch * width)
        e1 = min(e0 + PLAN_CHUNK, batch * width)
        e = np.arange(e0, e1)
        if e.size and np.any(x[e // width, c0 + e % width] != 0):
            flags[grp] = 1
    plan = np.full(ng, ng, np.int32)
    base = 0
    for c in range(0, ng, PLAN_THREADS):
        f = np.zeros(PLAN_THREADS, np.int32)
        f[:min(PLAN_THREADS, ng - c)] = flags[c:c + PLAN_THREADS]
        ballots = f.reshape(-1, 32) != 0
        counts = ballots.sum(axis=1)
        for warp in range(len(counts)):
            for lane in np.flatnonzero(ballots[warp]):
                at = base + counts[:warp].sum() + ballots[warp, :lane].sum()
                plan[at] = c + warp * 32 + lane
        base += counts.sum()
    return plan, np.int32(max(base, 1))


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("span", [128, 256, 1024])
@pytest.mark.parametrize("live", [0.0, 0.0625, 0.25, 1.0])
def test_plan_kernel_replay_is_the_plain_plan(live, span, batch):
    m = 2048 + 300                     # groups past x's width: read as 0
    ng = -(-m // span) + 1
    x = _live_x(m, span // 128, live, batch, seed=batch + span)
    for xv in (x, np.ascontiguousarray(x[:, :m - 7])):
        plan, k = _plan_replay(xv, ng, span)
        want, want_k = k3.device_group_plan_plain(torch.from_numpy(xv), ng,
                                                  span)
        assert np.array_equal(plan, want.numpy())
        assert k == int(want_k[0])
        jp, jk = jplan(jnp.asarray(np.pad(xv, ((0, 0), (0, ng * span
                                                        - xv.shape[1])))),
                       ng, span)
        assert np.array_equal(plan, np.asarray(jp)) and k == int(jk)


def test_plan_kernel_replay_compacts_past_one_chunk():
    """More than 256 groups: the compaction carries its count across
    chunks."""
    ng, span = 600, 128
    rng = np.random.default_rng(9)
    x = np.zeros((2, ng * span), np.float32)
    for gi in rng.choice(ng, 333, replace=False):
        x[rng.integers(2), gi * span + rng.integers(span)] = 1.0
    plan, k = _plan_replay(x, ng, span)
    want, want_k = k3.device_group_plan_plain(torch.from_numpy(x), ng, span)
    assert np.array_equal(plan, want.numpy()) and k == int(want_k[0]) == 333


# ---- K4's second pass through an Unpermute, replayed ------------------------

def _item_partials(r, x, items):
    """Each item's (B, 128) sum: its rows' products (any order: the
    tolerance covers it)."""
    vals, idx = r.vals.numpy(), r.idx.numpy().astype(np.int64)
    ct = r.ct.numpy()
    xp = np.zeros((x.shape[0], (int(ct.max()) + 1) * 128), np.float32)
    w = min(x.shape[1], xp.shape[1])
    xp[:, :w] = x[:, :w]
    out = np.zeros((len(items), x.shape[0], 128), np.float32)
    for i, (_, r0, r1) in enumerate(items[:, :3]):
        for row in range(r0, r1):
            ch, sl = divmod(row, 8)
            col = ct[ch] * 128 + idx[ch, sl]
            out[i] += vals[ch, sl][None] * xp[:, col]
    return out


def _unpermute_replay(part, gptr, dst, ldy, batch):
    """The second kernel with dst: the pack's column c summed in pack
    order (1-4 batch rows: 32 slices, slice r adding items r, r + 32, ...,
    then the slices in order; 8: the items in order), written to y's
    column dst[c]; y starts from zeros where no pack column lands."""
    y = np.zeros((batch, ldy), np.float32)
    nb = len(gptr) - 1
    for j in range(nb):
        its = part[gptr[j]:gptr[j + 1]]
        if batch_tile(batch) == 8:
            s = np.zeros((batch, 128), np.float32)
            for p in its:
                s = (s + p).astype(np.float32)
        else:
            s = np.zeros((batch, 128), np.float32)
            for q in range(32):
                t = np.zeros((batch, 128), np.float32)
                for p in its[q::32]:
                    t = (t + p).astype(np.float32)
                s = (s + t).astype(np.float32)
        for lane in range(128):
            d = dst[j * 128 + lane]
            if d >= 0:
                y[:, d] = s[:, lane]
    return y


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("name", ["run", "flat", "selecting"])
def test_k4_unpermute_replay_is_plain_k4_then_k5(name, batch):
    dims = {"run": (512, 640, 0.2, "powerlaw", 1),
            "flat": (256, 2048, 0.01, "uniform", 6),
            "selecting": (384, 256, 0.3, "powerlaw", 17)}[name]
    m, n, d, dist, seed = dims
    a = generators.random_sparse_matrix(m, n, density=d, seed=seed,
                                        distribution=dist)
    r = RsellMatrix.from_dense(a, device="cpu")
    np_ = r.padded[1]
    if name == "selecting":        # dead lanes, lanes past the pack's columns
        rng = np.random.default_rng(4)
        src = rng.permutation(np_ + 64)[:300] - 32
        src[::7] = -1
        u = k4.unpermute_lanes(src, np_, "cpu")
        assert not u.complete
    else:
        u = r.unpermute
        assert u is not None and u.complete
    x = generators.random_sparse_batch(batch, m, 0.5, seed=batch)
    items, gptr = k4.host_plans(r.cj.numpy(), r.ct.numpy(), np_ // 128,
                                H100_SMS)[batch_tile(batch)]
    part = _item_partials(r, x, items)
    y = _unpermute_replay(part, gptr, u.dst.numpy(), u.src.numel(), batch)
    args = (r.cj, r.ct, r.idx, r.vals, torch.from_numpy(x))
    want = permute_columns_plain(k4.rsell_spmm_plain(*args, n_padded=np_),
                                 u.src)
    np.testing.assert_allclose(y, want.numpy(), rtol=0, atol=ATOL_PLAIN)
    dead = (u.src.numpy() < 0) | (u.src.numpy() >= np_)
    assert not np.any(y[:, dead])
    # the wrapper on CPU tensors: the plain K4 then K5, any Unpermute
    got = k4.rsell_spmm(*args, n_padded=np_, unpermute=u)
    assert torch.equal(got, want)
    if name != "selecting":
        np.testing.assert_allclose(r.spmm(x).numpy(),
                                   reference.sgemm_cpu(x, a), atol=1e-3)


def test_unpermute_lanes_inverts_and_refuses_repeats():
    u = k4.unpermute_lanes(np.array([3, -1, 0, 7, 200]), 128, "cpu")
    assert u.dst[3] == 0 and u.dst[0] == 2 and u.dst[7] == 3
    assert int((u.dst >= 0).sum()) == 3 and not u.complete
    assert k4.unpermute_lanes(np.arange(128)[::-1], 128, "cpu").complete
    with pytest.raises(ValueError, match="one pack column"):
        k4.unpermute_lanes(np.array([1, 2, 1]), 128, "cpu")


# ---- K5's parts form ---------------------------------------------------------

@pytest.mark.parametrize("widths", [(256,), (256, 384), (128, 512, 256)])
@pytest.mark.parametrize("batch", [1, 4])
def test_permute_parts_is_the_concatenation_gathered(widths, batch):
    rng = np.random.default_rng(sum(widths) + batch)
    parts = [torch.from_numpy(rng.uniform(-1, 1, (batch, w))
                              .astype(np.float32)) for w in widths]
    total = sum(widths)
    src = torch.from_numpy(rng.integers(-8, total + 40, 700)
                           .astype(np.int32))
    want = permute_columns_plain(torch.cat(parts, dim=1), src)
    assert torch.equal(permute_columns_plain(parts, src), want)
    assert torch.equal(permute_columns(parts, src), want)   # CPU -> plain
    dead = (src < 0) | (src >= total)
    assert torch.count_nonzero(want[:, dead]) == 0


# ---- the C interface and the wrappers off the card ----------------------------

@pytest.mark.parametrize("name,first", [
    ("tps_awsp_spmm", ["plan", "count", "idx", "vals", "vals_kind", "x",
                       "part", "y", "counters"]),
    ("tps_group_plan", ["x", "plan", "count", "counters"]),
    ("tps_rsell_spmm", ["items", "gptr", "ct", "idx", "vals", "x", "part",
                        "y", "dst"]),
    ("tps_permute_columns", ["y0", "y1", "y2", "src", "out"])])
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
    assert names[:len(first)] == first, names
    assert "group_plan.cu" in _build.SOURCES


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["awsp", "plan", "parts", "unpermute"])
def test_new_wrappers_off_the_card_raise(name):
    i32 = _meta(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        if name == "awsp":
            k3.awsp_spmm(i32, _meta(1, dtype=torch.int32),
                         _meta(2, 4, 8, 128, dtype=torch.int8),
                         _meta(2, 4, 8, 128), _meta(3, 256), g=2)
        elif name == "plan":
            k3.device_group_plan(_meta(3, 256), 2, 128)
        elif name == "parts":
            permute_columns([_meta(3, 128), _meta(3, 256)], i32)
        else:
            u = k4.Unpermute(i32, _meta(128, dtype=torch.int32), True)
            k4.rsell_spmm(i32, i32, _meta(4, 8, 128, dtype=torch.int8),
                          _meta(4, 8, 128), _meta(3, 256), n_padded=128,
                          plan={}, unpermute=u)


def test_permute_takes_at_most_three_parts():
    parts = [torch.zeros((1, 128))] * (MAX_PARTS + 1)
    with pytest.raises(ValueError, match="parts"):
        permute_columns(parts, torch.zeros(4, dtype=torch.int32))
