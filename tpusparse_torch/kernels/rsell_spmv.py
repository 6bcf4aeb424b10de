"""K4: ragged SELL (RSELL) as a stream of 8-slot chunks —
``csrc/rsell_spmv.cu``, replacing the TPU kernel
``tpusparse/kernels/rsell_spmv.py:_rsell_kernel`` (through
``rsell_spmm_padded``, its run body and its flat body alike).

``y[b, cj[k]*128 + r] += sum_s vals[k, s, r] * x[b, ct[k]*128 + idx[k, s, r]]``
over every chunk k of (8 slots x 128 lanes). The result is ``(B, n)`` in the
pack's column order; ``RsellMatrix`` unpermutes a sorted pack with K5. The
TPU kernel's ``(B*8, N)`` output slab, its packed ``(cj << 16) | ct`` plan
and its SMEM plan segments were TPU workarounds and are not ported; the
16-bit id limit they imply is kept as a guard, so both packages refuse the
same shapes.

Work plan. The TPU kernel walks the stream in order on one core and adds
into a resident output. Blocks on the card run in no order, so
``rsell_plans`` sees the stream as rows (8 slot rows a chunk, row r at
r * 128) and cuts it, once per pack and for each batch tile, into items
(``window_items``): runs of whole chunks of one output group, sized as
``kernels/block_items.py`` sizes K6's and K7's items so that they fill the
card about once (``SHAPES``), and cut where they would read more than
``MAX_WINDOWS`` runs of one x window. An item's row carries those windows
and the first chunk of each run, so that from 2 batch rows a block stages
the windows once, before it streams its rows; at one batch row each warp
stages its chunks' windows itself, as the earlier K4 did (faster there).
A block sums one item into a (B, 128) partial, and a second kernel adds
each group's partials in a fixed order (deterministic: no float atomics).
Cutting by equal ``cj`` rather than by position makes the plan right for
any chunk order: the pack's zero tail chunks (``cj = 0`` after the last
group) and an empty pack's one zero chunk become items of group 0 that add
zeros. A run-aligned pack (run = 8) and a flat pack (run = 1) go through
the same body: a run only says where a group's chunks end, which the items
already know.

``work_plan`` is the earlier plan (runs of whole chunks, one plan for every
batch), kept for the kernel's history (``bench.abba`` gives it to the
earlier K4, K6 and K7).

``rsell_spmm`` launches the CUDA kernel for CUDA tensors and uses
``rsell_spmm_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels import _build, block_items
from tpusparse_torch.kernels.dense import batch_tile
from tpusparse_torch.utils import round_up

_LANES = 128
_SUB = 8
_ID_LIMIT = 0xFFFF
# csrc/rsell_spmv.cu kRsellWin: the x windows a block stages for its item,
# by batch tile (8 at 8 batch rows would cost 32 KB a block and 2 of its 8
# blocks an SM)
MAX_WINDOWS = {1: 8, 2: 8, 4: 8, 8: 4}
_WINDOWS = 8        # window columns an item row holds (kRsellItemWin)
# int32 an item: group, first row, end row, its windows (-1 past the last)
# and the first chunk of each window's run after the first (2^31 - 1 past
# the last)
ITEM_INTS = 3 + 2 * _WINDOWS - 1
_NO_RUN = 2**31 - 1
# By batch tile: blocks resident an SM (the kernel's __launch_bounds__, as
# K7's) and the row quantum of an item (a chunk).
SHAPES = {1: (8, _SUB), 2: (8, _SUB), 4: (6, _SUB), 8: (8, _SUB)}

_WIDE_VMEM_CAP = 96 * 1024 * 1024        # hard cap (v5e VMEM is 128 MB)


def wide_fits(m: int, n: int, batch: int = 1) -> bool:
    """The router's RSELL predicate, verbatim from the JAX package: True
    when the TPU wide kernel's whole-in-VMEM X/Y budget admits a
    (batch, m) x (m, n) product. Kept so that both routers decide alike;
    it is no limit of the CUDA kernel, which streams X and Y."""
    need = (batch * round_up(m, _LANES)
            + round_up(n, _LANES) * batch * _SUB) * 4
    return need <= _WIDE_VMEM_CAP


def check_plan_ids(m_padded: int, n_padded: int) -> None:
    """Refuse shapes whose group or window ids pass 16 bits, as the JAX
    package's packed ``(cj << 16) | ct`` plan does."""
    if n_padded // _LANES > _ID_LIMIT or m_padded // _LANES > _ID_LIMIT:
        raise ValueError(
            f"rsell plan ids are 16-bit: padded dims {m_padded}x{n_padded} "
            f"exceed {_ID_LIMIT * _LANES} — shard the matrix")


def work_plan(cj: np.ndarray, nb: int,
              per_item: int) -> tuple[np.ndarray, np.ndarray]:
    """Host work plan of a chunk stream: ``items`` (nitems, 3) int32 rows
    ``(group, first chunk, end chunk)``, sorted by group, each a run of
    equal ``cj`` of at most ``per_item`` chunks; ``gptr`` (nb + 1,) int32,
    the items of group j being ``items[gptr[j]:gptr[j+1]]``."""
    cj = np.asarray(cj, dtype=np.int64)
    if cj.size == 0:
        return np.zeros((0, 3), np.int32), np.zeros(nb + 1, np.int32)
    if cj.min() < 0 or cj.max() >= nb:
        raise ValueError(f"chunk groups must lie in [0, {nb})")
    start = np.flatnonzero(np.r_[True, cj[1:] != cj[:-1]])
    end = np.r_[start[1:], cj.size]
    pieces = -(-(end - start) // per_item)
    seg = np.repeat(np.arange(start.size), pieces)
    first = np.repeat(np.cumsum(pieces) - pieces, pieces)
    c0 = start[seg] + (np.arange(seg.size) - first) * per_item
    items = np.stack([cj[start[seg]], c0, np.minimum(c0 + per_item, end[seg])],
                     axis=1)
    items = items[np.argsort(items[:, 0], kind="stable")].astype(np.int32)
    gptr = np.searchsorted(items[:, 0], np.arange(nb + 1)).astype(np.int32)
    return items, gptr


def rsell_smem_bytes(bt: int) -> int:
    """Shared memory of a K4 block (``kRsellSmem``): the item's x windows,
    then the 4 warps' sums."""
    return max(MAX_WINDOWS[bt], 4) * bt * _LANES * 4


def window_items(cj: np.ndarray, ct: np.ndarray, nb: int, per_chunks: int,
                 max_windows: int, width: int = _WINDOWS
                 ) -> tuple[np.ndarray, np.ndarray]:
    """K4's items of a chunk stream: each group's run of chunks is cut, in
    order, into items of at most ``per_chunks`` chunks that read at most
    ``max_windows`` runs of one x window (``ct``), a cut falling where
    either fills. Returns ``items`` (nitems, 3 + 2 * width - 1) int32,
    sorted by group: first and end row (8 a chunk), the windows (-1 past
    the last) and the first chunk of each run after the first (2^31 - 1
    past the last); and ``gptr`` (nb + 1,) int32."""
    cj = np.asarray(cj, dtype=np.int64)
    ct = np.asarray(ct, dtype=np.int64)
    if not 0 < max_windows <= width:
        raise ValueError(f"max_windows={max_windows} outside [1, {width}]")
    if cj.size and (cj.min() < 0 or cj.max() >= nb):
        raise ValueError(f"chunk groups must lie in [0, {nb})")
    per_chunks = max(per_chunks, 1)
    brk = np.flatnonzero((cj[1:] != cj[:-1]) | (ct[1:] != ct[:-1])) + 1
    starts = np.r_[0, brk] if cj.size else np.zeros(0, np.int64)
    ends = np.r_[brk, cj.size] if cj.size else np.zeros(0, np.int64)
    rows: list[list[int]] = []
    item = None                       # [group, k0, k1, windows, run starts]
    for s0, e0 in zip(starts.tolist(), ends.tolist()):
        g, t = int(cj[s0]), int(ct[s0])
        if item is not None and item[0] != g:
            item = None
        pos = s0
        while pos < e0:
            if item is not None and (item[2] - item[1] == per_chunks
                                     or len(item[3]) == max_windows):
                item = None
            if item is None:
                item = [g, pos, pos, [], []]
                rows.append(item)
            if item[3]:
                item[4].append(pos)
            item[3].append(t)
            take = min(e0 - pos, per_chunks - (item[2] - item[1]))
            pos += take
            item[2] = pos
    out = np.full((len(rows), 3 + 2 * width - 1), -1, np.int64)
    out[:, 3 + width:] = _NO_RUN
    for i, (g, k0, k1, wins, runs) in enumerate(rows):
        out[i, :3] = g, k0 * _SUB, k1 * _SUB
        out[i, 3:3 + len(wins)] = wins
        out[i, 3 + width:3 + width + len(runs)] = runs
    out = out[np.argsort(out[:, 0], kind="stable")]
    gptr = np.searchsorted(out[:, 0], np.arange(nb + 1)).astype(np.int32)
    return out.astype(np.int32), gptr


def host_plans(cj: np.ndarray, ct: np.ndarray, nb: int, sms: int
               ) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """``window_items`` for each batch tile of ``SHAPES`` on a card of
    ``sms`` SMs: items of about the rows that fill the card's resident
    blocks once (``block_items.item_rows``), at most ``MAX_WINDOWS``
    windows each."""
    made: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    out = {}
    for bt, (resident, quantum) in SHAPES.items():
        key = (block_items.item_rows(len(cj) * _SUB, sms, resident, quantum)
               // _SUB, MAX_WINDOWS[bt])
        if key not in made:
            made[key] = window_items(cj, ct, nb, *key)
        out[bt] = made[key]
    return out


def rsell_plans(cj: np.ndarray, ct: np.ndarray, nb: int,
                device: torch.device) -> dict[int, block_items.ItemPlan]:
    """K4's work plans of a pack, one per launch shape (``SHAPES``), as
    int32 tensors on the CUDA ``device``."""
    return block_items.upload(
        host_plans(cj, ct, nb, _build.sm_count(device)), device)


def device_work_plan(cj: np.ndarray, nb: int,
                     device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``work_plan`` with items sized so the partial kernel runs about
    eight blocks per SM (``_build.split_work``), as int32 tensors on the
    CUDA ``device``."""
    per_item, _ = _build.split_work(max(len(cj), 1), 1, device)
    items, gptr = work_plan(cj, nb, per_item)
    return (torch.from_numpy(items).to(device),
            torch.from_numpy(gptr).to(device))


def rsell_spmm_plain(cj: torch.Tensor, ct: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor, x: torch.Tensor, *, n_padded: int,
                     n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4 on any device: the same fp32 products,
    each chunk's 8 slots summed, then added into its group with
    ``index_add_`` in fp64: the first group of a sorted skewed pack adds a
    long run of chunk sums, and an fp32 running sum of that run drifted
    7.6e-5 from the kernel on the 8192² powerlaw matrix at B = 8 (H100,
    PERF.md), too close to the 1e-4 comparison. x (B, m) fp32; columns past
    m read as 0."""
    check_plan_ids(round_up(x.shape[1], _LANES), n_padded)
    n = n_padded if n is None else n
    batch, width = x.shape
    if width == 0:
        x, width = x.new_zeros((batch, 1)), 1
    col = ct.long().view(-1, 1, 1) * _LANES + idx.long()
    ok = col < width
    col = torch.where(ok, col, 0)
    v = vals.float() * ok
    y = torch.zeros((batch, n_padded // _LANES, _LANES), dtype=torch.float64,
                    device=x.device)
    for b in range(batch):          # one row at a time bounds the temporary
        y[b].index_add_(0, cj.long(), (v * x[b][col]).sum(dim=1).double())
    return y.reshape(batch, n_padded)[:, :n].float().contiguous()


def rsell_spmm(cj: torch.Tensor, ct: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor, x: torch.Tensor, *, n_padded: int,
               n: int | None = None,
               plan: dict[int, block_items.ItemPlan] | None = None
               ) -> torch.Tensor:
    """K4: cj, ct (nchunk,) int32, idx (nchunk, 8, 128) int8, vals
    (nchunk, 8, 128) fp32, x (B, m) fp32 (columns past m read as 0) ->
    (B, n) fp32, n <= n_padded (default n_padded). ``plan``: the
    ``rsell_plans`` of the pack, built here (with host copies of cj and
    ct) when None."""
    if x.device.type == "cpu":
        return rsell_spmm_plain(cj, ct, idx, vals, x, n_padded=n_padded, n=n)
    check_plan_ids(round_up(x.shape[1], _LANES), n_padded)
    nchunk = vals.shape[0]
    if vals.shape != (nchunk, _SUB, _LANES) or idx.shape != vals.shape \
            or idx.dtype != torch.int8 or vals.dtype != torch.float32 \
            or cj.shape != (nchunk,) or ct.shape != (nchunk,) \
            or cj.dtype != torch.int32 or ct.dtype != torch.int32:
        raise ValueError(f"rsell_spmm: cj {tuple(cj.shape)} {cj.dtype}, ct "
                         f"{tuple(ct.shape)} {ct.dtype}, idx "
                         f"{tuple(idx.shape)} {idx.dtype}, vals "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"rsell_spmm: x must be fp32 (B, m), got {x.dtype} "
                         f"{tuple(x.shape)}")
    nb = n_padded // _LANES
    n = n_padded if n is None else n
    if n_padded % _LANES or not 0 <= n <= n_padded:
        raise ValueError(f"rsell_spmm: n={n}, n_padded={n_padded}")
    block_items.check_rows("rsell_spmm", nchunk, _SUB)
    dev = _build.require_cuda("rsell_spmm", cj, ct, idx, vals, x,
                              aligned=(idx, vals))
    batch = x.shape[0]
    bt = batch_tile(batch)
    block_items.check_smem("rsell_spmm", rsell_smem_bytes(bt),
                           _build.smem_limit(dev))
    if plan is None:
        plan = rsell_plans(cj.cpu().numpy(), ct.cpu().numpy(), nb, dev)
    items, gptr = block_items.resolve("rsell_spmm", plan, cj, nb, _SUB, bt,
                                      dev, SHAPES, cols=ITEM_INTS)
    nitems = items.shape[0]
    if x.shape[1] == 0:             # no row of x: every product reads 0
        x = x.new_zeros((batch, 1))
    part = torch.empty((nitems, batch, _LANES), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = _build.lib().tps_rsell_spmm(
        items.data_ptr(), gptr.data_ptr(), ct.data_ptr(), idx.data_ptr(),
        vals.data_ptr(), x.data_ptr(), part.data_ptr(), y.data_ptr(), nitems,
        batch, x.shape[1], n, dev.index, _build.stream_of(x))
    _build.check(rc, "rsell_spmm")
    rsell_spmm.launches += 1
    return y


rsell_spmm.launches = 0
