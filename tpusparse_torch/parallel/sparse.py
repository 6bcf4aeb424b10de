"""Multi-rank sparse SpMV/SpMM: every sharded format, each rank running the
port's kernel on its own shard.

Counterpart of ``tpusparse/parallel/sparse.py``, with the same function
names, partitions, padding rules and pack layouts. Where the JAX package
maps one program over a mesh (``shard_map``), here each rank is a process
that takes the same host pack (numpy arrays, or a format whose tensors lie
on the host), uploads its own shard to its device once (kept on the pack,
keyed by rank and device), runs its kernel, and joins the others through
``comm``. Partitions, over the mesh's ``"n"`` dimension of D ranks:

- ``n``: shard the output column groups; x is replicated; no communication
  until the result is gathered.
- ``m``: shard the contraction windows; each rank multiplies its slice of
  x and the partial y's are summed over the group.
- ``ring``: shard both: each rank owns a column-group slab and one band of
  x; the bands pass around the ring, D - 1 shifts, each rank multiplying
  the matching band of its slab.
- ``2d``: a ``("b", "n")`` mesh for SpMM: x's batch rows shard over
  ``"b"``, the format over ``"n"``.

Every function returns the full y on every rank (the JAX function's
replicated view), gathered over the group. GSPMD kept the JAX package's
output sharded, so that gather has no TPU counterpart in bytes; it is the
public meaning, and costs a call at D = 1 nothing but a view. The TPU
step geometry (``_sell_geom``, ``tune.sell_geometry``) stays behind.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tpusparse_torch.formats.bsr import _canonicalize_blocks, bsr_pack
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.kernels import dia_spmv as _dk
from tpusparse_torch.kernels.awsp_spmv import awsp_spmm
from tpusparse_torch.kernels.bsell_spmv import bsell_plans, bsell_spmm
from tpusparse_torch.kernels.bsr_spmv import bsr_plans, bsr_spmm
from tpusparse_torch.kernels.permute import permute_columns
from tpusparse_torch.kernels.rsell_spmv import rsell_plans, rsell_spmm
from tpusparse_torch.kernels.sell_spmv import sell_spmm
from tpusparse_torch.parallel import comm
from tpusparse_torch.parallel.mesh import axis_size, mesh_device
from tpusparse_torch.utils import round_up

_LANES = 128


# ----------------------------- helpers ------------------------------------


class _Rank:
    """This rank's view of a mesh dimension: its device, group, size and
    index."""

    def __init__(self, mesh: DeviceMesh, name: str):
        self.dev = mesh_device(mesh)
        self.group = mesh.get_group(name)
        self.d = axis_size(mesh, name)
        self.me = mesh.get_local_rank(name)
        # where this rank's shards are kept on a pack: (mesh shape, rank,
        # device); ``mesh.mesh`` builds a tensor each time it is read
        self.tag = (tuple(mesh.mesh.shape), self.me, str(self.dev))


def _rank(mesh: DeviceMesh, name: str = "n") -> _Rank:
    """The ``_Rank`` of ``mesh`` along ``name``, made once and kept on the
    mesh (its lookups cost more host time than a small call's kernel)."""
    ranks = vars(mesh).setdefault("_tps_ranks", {})
    if name not in ranks:
        ranks[name] = _Rank(mesh, name)
    return ranks[name]


def _as_2d(x: Any, dev: torch.device) -> tuple[torch.Tensor, bool]:
    """(x2d on ``dev`` as fp32, squeeze): (m,) activations become (1, m)."""
    xt = torch.as_tensor(x, dtype=torch.float32).to(dev)
    return (xt[None, :] if xt.ndim == 1 else xt), xt.ndim == 1


def _pad_axis(t: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` to a multiple of ``mult`` (shard divisibility:
    padded groups and windows multiply zeros and are cut off the output)."""
    pad = -t.shape[axis] % mult
    if not pad:
        return t
    shape = list(t.shape)
    shape[axis] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=axis)


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a) -> torch.Tensor:
    """A host tensor of a numpy array or tensor (left where it lies)."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _on_rank(holder, key: tuple, build: Callable[[], Any]) -> Any:
    """This rank's uploaded shard of ``holder`` (a pack dict or a format),
    built once under ``key`` and kept on the holder."""
    store = holder.setdefault("_rank_shards", {}) if isinstance(holder, dict) \
        else vars(holder).setdefault("_rank_shards", {})
    if key not in store:
        store[key] = build()
    return store[key]


def _up(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.contiguous().to(dev)


def _gather_cols(y: torch.Tensor, r: _Rank) -> torch.Tensor:
    """The group's (B, n_loc) output slabs side by side, in rank order."""
    return comm.all_gather_x(y, r.group, axis=1)


def _check_mesh(d: int, r: _Rank) -> None:
    if r.d != d:
        raise ValueError(f"packed for {d} shards, mesh has {r.d}")


def _ring(r: _Rank, x_loc: torch.Tensor,
          consume: Callable[[int, torch.Tensor], torch.Tensor]
          ) -> torch.Tensor:
    """The ring walk: consume band (me + s) % D of x with its chunk, pass
    the chunk to the left neighbour; D - 1 shifts, the last band needs
    none."""
    xc = x_loc
    y = None
    for s in range(r.d - 1):
        part = consume(s, xc)
        y = part if y is None else y + part
        xc = comm.ring_shift(xc, r.group, shift=-1)
    part = consume(r.d - 1, xc)
    return part if y is None else y + part


# ----------------------------- SELL ---------------------------------------


def sell_spmm_sharded(s: SellMatrix, x: Any, mesh: DeviceMesh,
                      partition: str = "n") -> torch.Tensor:
    """y = x @ A with SELL-format A sharded over ``mesh`` (K1 on each
    rank's shard). x: (m,) or (b, m). int8 storage threads its per-column
    scales with the column groups: the kernel dequantizes after its sum,
    and scaling commutes with the partial sums of ``m`` and ``ring``."""
    r = _rank(mesh)
    x2d, squeeze = _as_2d(x, r.dev)
    nb, nt = s.vals.shape[0], s.vals.shape[1]
    sc = s.scales
    key = ("sell", partition, r.tag)

    def groups(pad_nt: bool):
        """This rank's column-group slab (idx, vals, scales), windows padded
        to D where ``pad_nt``."""
        idx, vals = _pad_axis(s.idx, 0, r.d), _pad_axis(s.vals, 0, r.d)
        if pad_nt:
            idx, vals = _pad_axis(idx, 1, r.d), _pad_axis(vals, 1, r.d)
        nbl = idx.shape[0] // r.d
        cut = slice(r.me * nbl, (r.me + 1) * nbl)
        scl = None if sc is None else _up(_pad_axis(sc, 0, r.d)[cut], r.dev)
        return _up(idx[cut], r.dev), _up(vals[cut], r.dev), scl

    if partition == "n":
        idx_l, vals_l, scl = _on_rank(s, key, lambda: groups(False))
        y = _gather_cols(sell_spmm(idx_l, vals_l, x2d, scales=scl), r)
    elif partition == "m":
        ntl = -(-nt // r.d)
        cut = slice(r.me * ntl, (r.me + 1) * ntl)
        idx_l, vals_l, scl = _on_rank(s, key, lambda: (
            _up(_pad_axis(s.idx, 1, r.d)[:, cut], r.dev),
            _up(_pad_axis(s.vals, 1, r.d)[:, cut], r.dev),
            None if sc is None else _up(sc, r.dev)))
        xp = _pad_axis(x2d, 1, ntl * r.d * _LANES)
        x_loc = xp[:, r.me * ntl * _LANES:(r.me + 1) * ntl * _LANES]
        y = comm.psum_y(sell_spmm(idx_l, vals_l, x_loc.contiguous(),
                                  scales=scl), r.group)
    elif partition == "ring":
        band = -(-nt // r.d)

        def bands():
            idx_l, vals_l, scl = groups(True)
            return ([idx_l[:, b * band:(b + 1) * band].contiguous()
                     for b in range(r.d)],
                    [vals_l[:, b * band:(b + 1) * band].contiguous()
                     for b in range(r.d)], scl)

        idx_b, vals_b, scl = _on_rank(s, key, bands)
        xp = _pad_axis(x2d, 1, band * r.d * _LANES)
        x_loc = xp[:, r.me * band * _LANES:(r.me + 1) * band * _LANES]

        def consume(step, xc):
            b = (r.me + step) % r.d
            return sell_spmm(idx_b[b], vals_b[b], xc, scales=scl)

        y = _gather_cols(_ring(r, x_loc.contiguous(), consume), r)
    elif partition == "2d":
        rb = _rank(mesh, "b")
        idx_l, vals_l, scl = _on_rank(s, key, lambda: groups(False))
        b_real = x2d.shape[0]
        xp = _pad_axis(x2d, 0, rb.d)                  # zero batch rows
        bl = xp.shape[0] // rb.d
        x_loc = xp[rb.me * bl:(rb.me + 1) * bl].contiguous()
        y = _gather_cols(sell_spmm(idx_l, vals_l, x_loc, scales=scl), r)
        y = comm.all_gather_x(y, rb.group, axis=0)[:b_real]
    else:
        raise ValueError(f"unknown partition {partition!r}")
    y = y[:, :s.shape[1]]
    return y[0] if squeeze else y


# ----------------------------- RSELL ---------------------------------------


def rsell_rank_shard(shards, mesh: DeviceMesh) -> tuple:
    """This rank's ragged-SELL shard on its device, uploaded once and kept
    on ``shards``: ``((cj, ct, idx, vals), plans, perm_src)``."""
    r = _rank(mesh)
    _check_mesh(shards.n_shards, r)
    nb_loc = shards.group_map.shape[1]

    def upload():
        arrs = [_up(_t(getattr(shards, k)[r.me]), r.dev)
                for k in ("cj", "ct", "idx", "vals")]
        plans = None if r.dev.type != "cuda" else rsell_plans(
            shards.cj[r.me], shards.ct[r.me], nb_loc, r.dev)
        src = None if shards.perm_src is None else \
            torch.from_numpy(shards.perm_src).to(r.dev)
        return arrs, plans, src

    return _on_rank(shards, ("rsell", r.tag), upload)


def rsell_spmm_sharded(shards, x: Any, mesh: DeviceMesh) -> torch.Tensor:
    """y = x @ A with ragged-SELL chunk shards (``formats.rsell.
    rsell_shard_pack``) over ``mesh``: K4 on each rank's chunk stream, the
    group's outputs gathered in (shard, local column) order, then one
    static column permutation (K5) back to the user's order; a contiguous
    pack (``perm_plan`` None) is in order already."""
    r = _rank(mesh)
    (cj, ct, idx, vals), plans, src = rsell_rank_shard(shards, mesh)
    x2d, squeeze = _as_2d(x, r.dev)
    nb_loc = shards.group_map.shape[1]
    y = rsell_spmm(cj, ct, idx, vals, x2d.contiguous(),
                   n_padded=nb_loc * _LANES, plan=plans)
    y = _gather_cols(y, r)
    y = y[:, :shards.shape[1]] if src is None else permute_columns(y, src)
    return y[0] if squeeze else y


# ----------------------------- BINNED ---------------------------------------


def binned_spmm_sharded(bm, x: Any, mesh: DeviceMesh) -> torch.Tensor:
    """Output-sharded binned SELL: each width bucket's column groups shard
    over the mesh (zero groups pad them to D), K1 on each rank's slab of
    every bucket, the bucket outputs joined in pack order and the pack's
    column sort undone by K5: the multi-rank twin of
    ``BinnedSellMatrix._run``."""
    r = _rank(mesh)
    x2d, squeeze = _as_2d(x, r.dev)

    def upload():
        out = []
        for bk in bm.buckets:
            idx, vals = _pad_axis(bk["idx"], 0, r.d), \
                _pad_axis(bk["vals"], 0, r.d)
            nbl = idx.shape[0] // r.d
            cut = slice(r.me * nbl, (r.me + 1) * nbl)
            out.append((_up(idx[cut], r.dev), _up(vals[cut], r.dev)))
        return out, bm.perm_src.to(r.dev)

    slabs, src = _on_rank(bm, ("binned", r.tag), upload)
    xc = x2d.contiguous()
    parts = []
    for (idx_l, vals_l), bk in zip(slabs, bm.buckets):
        yk = _gather_cols(sell_spmm(idx_l, vals_l, xc), r)
        parts.append(yk[:, :bk["vals"].shape[0] * _LANES])  # shard pads off
    y = permute_columns(parts, src)
    return y[0] if squeeze else y


# ----------------------------- AWSP ----------------------------------------


def awsp_shard_slabs(w, n_devices: int, partition: str) -> tuple:
    """One-time slab repack for the ``m`` and ``ring`` partitions, the JAX
    package's layout: the real window groups split into ``n_devices`` slabs
    of ceil(ng/D) groups, each with its own zero group appended; ``ring``
    then lays every slab side by side with the column groups padded to D.
    Returns host (or ``w``'s device) tensors (idx, vals): ``m``: (D, nb,
    (ng_loc + 1) * G, W, 128); ``ring``: (nb_pad, D * (ng_loc + 1) * G, W,
    128). Activation-independent: build once and pass ``slabs=``."""
    d, g, ng = n_devices, w.g, w.n_groups
    ng_loc = -(-ng // d)
    nb = w.vals.shape[0]

    def per_slab(leaf):
        rest = tuple(leaf.shape[2:])
        real = _pad_axis(leaf[:, :ng * g], 1, d * ng_loc * g)
        s5 = real.reshape((nb, d, ng_loc * g) + rest).movedim(1, 0)
        zero = real.new_zeros((d, nb, g) + rest)   # each slab's zero group
        return torch.cat([s5, zero], dim=2)

    idx_s, vals_s = per_slab(w.idx), per_slab(w.vals)
    if partition == "ring":
        def ring(t):
            return _pad_axis(t.movedim(0, 1).reshape(
                nb, d * (ng_loc + 1) * g, *t.shape[3:]), 0, d)
        idx_s, vals_s = ring(idx_s), ring(vals_s)
    return idx_s.contiguous(), vals_s.contiguous()


def _plan_np(w, x2d: torch.Tensor) -> np.ndarray:
    return w.plan(x2d.detach().cpu().numpy())


def awsp_spmm_sharded(w, x: Any, mesh: DeviceMesh, partition: str = "n",
                      plan: np.ndarray | None = None,
                      slabs: tuple | None = None) -> torch.Tensor:
    """y = x @ A with AWSP-format A sharded over ``mesh`` (K3 on each
    rank's shard, with the exact host plan of this x):

    - ``n``: column groups shard; every rank skips the same dead window
      groups of its own slab;
    - ``m``: window groups shard (each slab with its own zero group and a
      local plan, padded to the longest with that zero group); partial y's
      summed over the group;
    - ``ring``: column groups shard and x passes around the ring in
      window-group bands, each band consumed with its own local plan."""
    r = _rank(mesh)
    x2d, squeeze = _as_2d(x, r.dev)
    g, ng = w.g, w.n_groups
    ng_loc = -(-ng // r.d)
    if plan is None:
        plan = _plan_np(w, x2d)
    plan = np.asarray(plan)

    if partition == "n":
        def upload():
            idx, vals = _pad_axis(w.idx, 0, r.d), _pad_axis(w.vals, 0, r.d)
            nbl = idx.shape[0] // r.d
            cut = slice(r.me * nbl, (r.me + 1) * nbl)
            return _up(idx[cut], r.dev), _up(vals[cut], r.dev)

        idx_l, vals_l = _on_rank(w, ("awsp", "n", r.tag),
                                 upload)
        plan_t = torch.from_numpy(plan.astype(np.int32)).to(r.dev)
        k = torch.full((1,), plan.size, dtype=torch.int32, device=r.dev)
        y = _gather_cols(awsp_spmm(plan_t, k, idx_l, vals_l,
                                   x2d.contiguous(), g=g), r)
    elif partition in ("m", "ring"):
        plan = plan[plan < ng]                  # drop the empty-x marker
        rows_slab = ng_loc * g * _LANES
        slab_of = plan // ng_loc
        counts = np.bincount(slab_of, minlength=r.d)
        lmax = max(int(counts.max()) if counts.size else 0, 1)
        plans = np.full((r.d, lmax), ng_loc, dtype=np.int32)
        for dd in range(r.d):
            loc = plan[slab_of == dd] - dd * ng_loc
            plans[dd, :loc.size] = loc
        plans_t = torch.from_numpy(plans).to(r.dev)
        k = torch.full((1,), lmax, dtype=torch.int32, device=r.dev)
        xp = _pad_axis(x2d, 1, r.d * rows_slab)[:, :r.d * rows_slab]
        x_loc = xp[:, r.me * rows_slab:(r.me + 1) * rows_slab].contiguous()

        def upload():
            idx_s, vals_s = slabs if slabs is not None else \
                awsp_shard_slabs(w, r.d, partition)
            if partition == "m":
                return _up(idx_s[r.me], r.dev), _up(vals_s[r.me], r.dev)
            nbl = idx_s.shape[0] // r.d
            bandw = (ng_loc + 1) * g
            cut = slice(r.me * nbl, (r.me + 1) * nbl)
            return ([_up(idx_s[cut, b * bandw:(b + 1) * bandw], r.dev)
                     for b in range(r.d)],
                    [_up(vals_s[cut, b * bandw:(b + 1) * bandw], r.dev)
                     for b in range(r.d)])

        idx_l, vals_l = _on_rank(
            w, ("awsp", partition, r.tag), upload)
        if partition == "m":
            y = comm.psum_y(awsp_spmm(plans_t[r.me], k, idx_l, vals_l, x_loc,
                                      g=g), r.group)
        else:
            def consume(step, xc):
                b = (r.me + step) % r.d
                return awsp_spmm(plans_t[b], k, idx_l[b], vals_l[b], xc, g=g)

            y = _gather_cols(_ring(r, x_loc, consume), r)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    y = y[:, :w.shape[1]]
    return y[0] if squeeze else y


# ----------------------------- TCSR ----------------------------------------


def tcsr_shard_pack(a_or_csr, n_shards: int,
                    expect_batch: int = 1) -> dict[str, Any]:
    """Shard a TCSR matrix by output column groups, as the JAX package
    does: both tiers (the SELL-packed tiles and the dense blocks) split per
    shard, each list re-canonicalized and padded with zero tiles or blocks
    to the longest. Group counts pad to the shard count. numpy arrays."""
    from tpusparse_torch.formats.tcsr import (TcsrMatrix,
                                              _canonicalize_sell_tiles)

    f = a_or_csr if isinstance(a_or_csr, TcsrMatrix) else (
        TcsrMatrix.from_csr(a_or_csr, expect_batch=expect_batch,
                            device="cpu")
        if isinstance(a_or_csr, CsrMatrix)
        else TcsrMatrix.from_dense(a_or_csr, expect_batch=expect_batch,
                                   device="cpu"))
    mp, np_ = f.padded
    nb = np_ // _LANES
    nb_pad = -(-nb // n_shards) * n_shards
    gpd = nb_pad // n_shards
    out: dict[str, Any] = dict(shape=f.shape, padded=(mp, nb_pad * _LANES),
                               w=f.w, nnz=f.nnz, n_shards=n_shards,
                               gpd=gpd)

    if f.n_sell:
        s_bi, s_bj = _np(f.s_bi), _np(f.s_bj)
        idx, vals = _np(f.idx), _np(f.vals)
        # drop the whole pack's zero and pad tiles: each shard's own
        # canonicalization inserts what it needs
        live = vals.reshape(vals.shape[0], -1).any(axis=1)
        s_bi, s_bj = s_bi[live], s_bj[live]
        idx, vals = idx[live], vals[live]
        dev = s_bj // gpd
        per = [_canonicalize_sell_tiles(
            s_bi[dev == sh], s_bj[dev == sh] - sh * gpd, idx[dev == sh],
            vals[dev == sh], gpd, f.w) for sh in range(n_shards)]
        lmax = max(p[0].size for p in per)
        sbi = np.zeros((n_shards, lmax), np.int32)
        sbj = np.full((n_shards, lmax), gpd - 1, np.int32)
        sidx = np.zeros((n_shards, lmax, f.w, _LANES), np.int8)
        svals = np.zeros((n_shards, lmax, f.w, _LANES), vals.dtype)
        for sh, (bi_l, bj_l, idx_l, val_l) in enumerate(per):
            k = bi_l.size
            # bj stays non-decreasing: pad slots sit at gpd - 1 (zero tiles)
            sbi[sh, :k] = bi_l
            sbj[sh, :k] = bj_l
            sidx[sh, :k] = idx_l
            svals[sh, :k] = val_l
        out.update(s_bi=sbi, s_bj=sbj, idx=sidx, vals=svals)

    if f.bsr is not None:
        b = f.bsr
        bi, bj, blocks = _np(b.bi), _np(b.bj), _np(b.blocks)
        live = blocks.reshape(blocks.shape[0], -1).any(axis=1)
        bi, bj, blocks = bi[live], bj[live], blocks[live]
        dev = bj // gpd
        shards = [_canonicalize_blocks(
            bi[dev == sh], bj[dev == sh] - sh * gpd,
            lambda order, sel=(dev == sh): blocks[sel][order],
            gpd, b.block_m, blocks.dtype) for sh in range(n_shards)]
        dbi, dbj, dblk = _pad_block_lists(shards, b.block_m, gpd - 1,
                                          blocks.dtype)
        out.update(d_bi=dbi, d_bj=dbj, blocks=dblk, block_m=b.block_m)
    return out


def tcsr_spmm_sharded(packed: dict[str, Any], x: Any,
                      mesh: DeviceMesh) -> torch.Tensor:
    """Output-sharded TCSR SpMV/SpMM from ``tcsr_shard_pack``: each rank
    runs its SELL-tier tiles (K7) and dense-tier blocks (K6) over its own
    column-group slab and adds the two."""
    r = _rank(mesh)
    _check_mesh(packed["n_shards"], r)
    x2d, squeeze = _as_2d(x, r.dev)
    gpd = packed["gpd"]
    n_local = gpd * _LANES
    cuda = r.dev.type == "cuda"

    def upload():
        sell = dense = None
        if "vals" in packed:
            sbi, sbj, idx, vals = (_up(_t(packed[k][r.me]), r.dev)
                                   for k in ("s_bi", "s_bj", "idx", "vals"))
            plans = bsell_plans(packed["s_bj"][r.me], gpd, packed["w"],
                                r.dev) if cuda else None
            sell = (sbi, sbj, idx, vals, plans)
        if "blocks" in packed:
            dbi, dbj, blk = (_up(_t(packed[k][r.me]), r.dev)
                             for k in ("d_bi", "d_bj", "blocks"))
            plans = bsr_plans(packed["d_bj"][r.me], gpd, packed["block_m"],
                              r.dev) if cuda else None
            dense = (dbi, dbj, blk, plans)
        return sell, dense

    sell, dense = _on_rank(packed, ("tcsr", r.tag), upload)
    xc = x2d.contiguous()
    y = None
    if sell is not None:
        sbi, sbj, idx, vals, plans = sell
        y = bsell_spmm(sbi, sbj, idx, vals, xc, n_padded=n_local, plan=plans)
    if dense is not None:
        dbi, dbj, blk, plans = dense
        yd = bsr_spmm(dbi, dbj, blk, xc, n_padded=n_local, plan=plans)
        y = yd if y is None else y + yd
    if y is None:
        y = torch.zeros((xc.shape[0], n_local), dtype=torch.float32,
                        device=r.dev)
    y = _gather_cols(y, r)[:, :packed["shape"][1]]
    return y[0] if squeeze else y


# ----------------------------- BSR -----------------------------------------


def _pad_block_lists(per_shard, tbm, pad_bj, dtype):
    """Rectangularize per-shard (bi, bj, blocks) lists: pad every list to
    the longest with zero blocks adding into group ``pad_bj``."""
    nmax = max(max(len(t[0]) for t in per_shard), 1)
    k_sh = len(per_shard)
    bi_s = np.zeros((k_sh, nmax), np.int32)
    bj_s = np.full((k_sh, nmax), pad_bj, np.int32)
    blk_s = np.zeros((k_sh, nmax, tbm, _LANES), dtype)
    for sh, (bi, bj, blk) in enumerate(per_shard):
        k = len(bi)
        bi_s[sh, :k] = bi
        bj_s[sh, :k] = bj
        blk_s[sh, :k] = blk
    return bi_s, bj_s, blk_s


def bsr_shard_pack(a, n_shards: int, block_m: int = 128,
                   partition: str = "n") -> dict[str, Any]:
    """Pack dense A into per-shard BSR lists, as the JAX package does:

    - ``n``: each shard owns ceil(nb/D) output column groups;
    - ``m``: each shard owns ceil(mb/D) contraction block rows (partial y's
      summed at run time);
    - ``ring``: each shard owns an output slab, and its list is split per
      contraction band (x passes around the ring).

    Lists pad with zero blocks to the longest (per shard, or per shard and
    band); numpy arrays."""
    full = bsr_pack(a, block_m=block_m)
    mp, np_ = full["padded"]
    tbm = full["block_m"]
    bi, bj, blocks = full["bi"], full["bj"], full["blocks"]
    nb = np_ // _LANES
    mb = mp // tbm

    def subset(sel, bi_off, bj_off, n_groups_local):
        return _canonicalize_blocks(
            bi[sel] - bi_off, bj[sel] - bj_off,
            lambda order: blocks[sel][order], n_groups_local, tbm,
            blocks.dtype)

    meta = dict(shape=full["shape"], block_m=tbm, nnz=full["nnz"],
                n_shards=n_shards, partition=partition)
    if partition == "n":
        gpd = -(-nb // n_shards)
        dev = bj // gpd
        shards = [subset(dev == sh, 0, sh * gpd, gpd)
                  for sh in range(n_shards)]
        bi_s, bj_s, blk_s = _pad_block_lists(shards, tbm, gpd - 1,
                                             blocks.dtype)
        return dict(bi=bi_s, bj=bj_s, blocks=blk_s,
                    padded=(mp, gpd * n_shards * _LANES), **meta)
    if partition == "m":
        rpd = -(-mb // n_shards)
        dev = bi // rpd
        shards = [subset(dev == sh, sh * rpd, 0, nb)
                  for sh in range(n_shards)]
        bi_s, bj_s, blk_s = _pad_block_lists(shards, tbm, nb - 1,
                                             blocks.dtype)
        return dict(bi=bi_s, bj=bj_s, blocks=blk_s,
                    padded=(rpd * n_shards * tbm, np_), **meta)
    if partition == "ring":
        gpd = -(-nb // n_shards)
        rpd = -(-mb // n_shards)
        dev = bj // gpd
        band = bi // rpd
        flat = [subset((dev == sh) & (band == bb), bb * rpd, sh * gpd, gpd)
                for sh in range(n_shards) for bb in range(n_shards)]
        bi_s, bj_s, blk_s = _pad_block_lists(flat, tbm, gpd - 1,
                                             blocks.dtype)
        lm = bi_s.shape[1]
        return dict(bi=bi_s.reshape(n_shards, n_shards, lm),
                    bj=bj_s.reshape(n_shards, n_shards, lm),
                    blocks=blk_s.reshape(n_shards, n_shards, lm, tbm,
                                         _LANES),
                    padded=(rpd * n_shards * tbm,
                            gpd * n_shards * _LANES), **meta)
    raise ValueError(f"unknown partition {partition!r}")


def bsr_spmm_sharded(packed: dict[str, Any], x: Any,
                     mesh: DeviceMesh) -> torch.Tensor:
    """Sharded BSR SpMV/SpMM from ``bsr_shard_pack`` (K6 on each rank's
    list). For SpMM over a 2-D ``("b", "n")`` mesh, pack with
    ``partition='n'``: x's batch rows shard over ``"b"``."""
    r = _rank(mesh)
    _check_mesh(packed["n_shards"], r)
    x2d, squeeze = _as_2d(x, r.dev)
    mp, np_ = packed["padded"]
    tbm = packed["block_m"]
    b = x2d.shape[0]
    partition = packed.get("partition", "n")
    cuda = r.dev.type == "cuda"

    def upload(groups: int):
        """This rank's lists: one (bi, bj, blocks, plans), or one a band
        for ``ring``."""
        lists = [(packed["bi"][r.me], packed["bj"][r.me],
                  packed["blocks"][r.me])]
        if partition == "ring":
            lists = [(bi[bb], bj[bb], blk[bb]) for bi, bj, blk in lists
                     for bb in range(r.d)]
        return [(_up(_t(bi), r.dev), _up(_t(bj), r.dev), _up(_t(blk), r.dev),
                 bsr_plans(bj, groups, tbm, r.dev) if cuda else None)
                for bi, bj, blk in lists]

    def run(lst, xs, n_padded):
        bi, bj, blk, plans = lst
        return bsr_spmm(bi, bj, blk, xs, n_padded=n_padded, plan=plans)

    if partition == "n":
        n_local = np_ // r.d
        lst = _on_rank(packed, ("bsr", r.tag),
                       lambda: upload(n_local // _LANES))[0]
        if "b" in mesh.mesh_dim_names:           # 2-D batch x output mesh
            rb = _rank(mesh, "b")
            xp = _pad_axis(x2d, 0, rb.d)
            bl = xp.shape[0] // rb.d
            x_loc = xp[rb.me * bl:(rb.me + 1) * bl].contiguous()
            y = _gather_cols(run(lst, x_loc, n_local), r)
            y = comm.all_gather_x(y, rb.group, axis=0)
        else:
            y = _gather_cols(run(lst, x2d.contiguous(), n_local), r)
    elif partition == "m":
        rows = mp // r.d
        lst = _on_rank(packed, ("bsr", r.tag),
                       lambda: upload(np_ // _LANES))[0]
        xp = _pad_axis(x2d, 1, mp)[:, :mp]
        x_loc = xp[:, r.me * rows:(r.me + 1) * rows].contiguous()
        y = comm.psum_y(run(lst, x_loc, np_), r.group)
    elif partition == "ring":
        n_local = np_ // r.d
        rows = mp // r.d
        lists = _on_rank(packed, ("bsr", r.tag),
                         lambda: upload(n_local // _LANES))
        xp = _pad_axis(x2d, 1, mp)[:, :mp]
        x_loc = xp[:, r.me * rows:(r.me + 1) * rows].contiguous()
        y = _gather_cols(_ring(r, x_loc, lambda step, xc: run(
            lists[(r.me + step) % r.d], xc, n_local)), r)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    y = y[:b, :packed["shape"][1]]
    return y[0] if squeeze else y


# ----------------------------- DIA -----------------------------------------


def _pick_rows(k: int, hr: int, nr: int) -> int:
    """The JAX package's rows per grid block of its DIA kernel
    (``tpusparse/kernels/dia_spmv.py:_pick_rows``): ~2 MB of vals and x a
    step, a multiple of the halo height, under a 6 MB vals budget. Kept
    only for the halo partition's slab width, so that each rank's slab and
    strips are the JAX package's."""
    raw = max(64, int(2_000_000 // (_LANES * 4 * (k + 1))))
    r = hr * max(1, -(-raw // hr))
    while k * r * _LANES * 4 > 6_000_000 and r > hr:
        r -= hr
    return min(r, round_up(nr, hr))


def halo_slab_rows(k: int, hrows: int, n: int, d: int) -> int:
    """The JAX package's slab quantum for the halo partition's kernel body:
    ``_pick_rows``, then walked down in ``hrows`` steps to the largest rows
    whose global pad (``-n % (d * rows * 128)``) stays within 5% of n (the
    least pad if none does)."""
    nr0 = -(-(-(-n // d)) // _LANES)          # rows of a ceil-split slab
    rows = _pick_rows(k, hrows, nr0)
    best, best_pad = rows, (-n) % (d * rows * _LANES)
    r = rows
    while r >= hrows:
        pad = (-n) % (d * r * _LANES)
        if pad < best_pad:
            best, best_pad = r, pad
        if pad <= 0.05 * n:
            best, best_pad = r, pad
            break
        r -= hrows
    return best


def dia_kernel_body(dm, b: int, d: int) -> bool:
    """True where the halo partition runs K8 with strips (the JAX package's
    rule): one vector, a halo strip within a slab, and an operator that
    ``fits`` the kernel on a slab."""
    def rule() -> bool:
        n_loc = -(-dm.shape[1] // d)
        hs = _dk.strip_width(dm.offsets, dm.sym)
        return hs <= n_loc and _dk.fits(dm.offsets, dm.sym, n_loc)

    return b == 1 and _on_rank(dm, ("dia-body", d), rule)


def dia_spmm_sharded(dm, x: Any, mesh: DeviceMesh,
                     partition: str = "halo") -> torch.Tensor:
    """y = x @ A with DIA-format A (``formats/dia.py``) sharded over
    ``mesh``: each rank owns a contiguous slab of output columns.

    - ``halo``: x shards with the slabs; each rank receives its neighbours'
      edges by ring shifts (one each way, and for a symmetric operator the
      left neighbour's edge of the vals rows, zeroed on rank 0), then
      multiplies locally. A square operator whose band fits a slab. At one
      vector where the kernel fits, that is K8 with the edges as its halo
      strips, on the JAX package's slab width; elsewhere the shifted torch
      form (the JAX package's XLA form).
    - ``n``: x replicated, the diagonals shard on their column axis.

    A symmetric operator whose largest offset passes a slab is expanded to
    full storage first (``desym``): its mirror reads would reach past the
    left neighbour. The wrap of the ring hands rank 0 the last rank's edge
    and the last rank rank 0's: those values meet coefficients the packer
    zeroed (and vals strips zeroed on rank 0)."""
    r = _rank(mesh)
    x2d, squeeze = _as_2d(x, r.dev)
    m, n = dm.shape
    d, me = r.d, r.me
    if dm.sym and dm.offsets and max(dm.offsets) > -(-max(n, 1) // d):
        dm = _on_rank(dm, ("desym",), dm.desym)
    offsets = dm.offsets
    dmin = min(offsets) if offsets else 0
    dmax = max(offsets) if offsets else 0
    if dm.sym:
        dmin = min(dmin, -dmax)               # mirrors reach -dmax
    np_ = n + (-n % d)
    n_loc = np_ // d
    b = x2d.shape[0]

    def slab(width: int) -> torch.Tensor:
        """This rank's vals columns of a slab ``width`` wide."""
        vals = dm.vals[:, :n]
        vals = F.pad(vals, (0, d * width - vals.shape[1]))
        return _up(vals[:, me * width:(me + 1) * width], r.dev)

    def left_vals(vals_loc, hs, zeros=None):
        """The left neighbour's last ``hs`` vals columns; rank 0, which has
        no left neighbour, takes zeros (``zeros``, or new ones)."""
        vh = comm.ring_shift(vals_loc[:, -hs:], r.group, 1)
        if me == 0:
            return torch.zeros_like(vh) if zeros is None else zeros
        return vh.contiguous()

    def padded(t, width):
        """``t`` (.., n) with zero columns to ``width``."""
        return t if t.shape[-1] == width else F.pad(t, (0, width - n))

    if partition == "halo":
        if m != n:
            raise ValueError("partition='halo' needs a square operator "
                             f"(shape {dm.shape}); use partition='n'")
        hl, hr = max(0, -dmin), max(0, dmax)
        if max(hl, hr) > n_loc:
            raise ValueError(
                f"halo {max(hl, hr)} exceeds the {n_loc}-element slab at "
                f"D={d}; band too wide for this mesh, use partition='n'")
        if dia_kernel_body(dm, b, d):
            def body():
                """The kernel body's slab width, this rank's slab, K8's
                plan and the zero vals strip of rank 0."""
                hrows = _dk.halo_rows(offsets, dm.sym)
                rows = halo_slab_rows(len(offsets), hrows, n, d)
                n_loc2 = (n + (-n % (d * rows * _LANES))) // d
                return (n_loc2, hrows * _LANES, slab(n_loc2),
                        _dk.dia_plan(offsets, dm.sym),
                        torch.zeros((len(offsets), hrows * _LANES),
                                    device=r.dev))

            n_loc2, hs, vals_loc, plan, zeros = _on_rank(
                dm, ("dia-k8", r.tag), body)
            xv = padded(x2d[0], d * n_loc2)[me * n_loc2:(me + 1) * n_loc2]
            sl = comm.ring_shift(xv[-hs:], r.group, 1)
            sr = comm.ring_shift(xv[:hs], r.group, -1)
            vs = left_vals(vals_loc, hs, zeros) if dm.sym else None
            y = _dk.dia_spmv(offsets, vals_loc, xv.contiguous(), sym=dm.sym,
                             n=n_loc2, plan=plan, xstrip_l=sl, xstrip_r=sr,
                             vstrip=vs)
            y = _gather_cols(y[None, :], r)[:, :n]
            return y[0] if squeeze else y
        vals_loc = _on_rank(dm, ("dia", r.tag),
                            lambda: slab(n_loc))
        x_loc = padded(x2d, np_)[:, me * n_loc:(me + 1) * n_loc]
        parts = []
        if hl:
            parts.append(comm.ring_shift(x_loc[:, -hl:], r.group, 1))
        parts.append(x_loc)
        if hr:
            parts.append(comm.ring_shift(x_loc[:, :hr], r.group, -1))
        xp = torch.cat(parts, dim=1)
        if dm.sym and dmax:
            vexp = torch.cat([left_vals(vals_loc, dmax), vals_loc], dim=1)
        y = torch.zeros((b, n_loc), dtype=torch.float32, device=r.dev)
        for i, off in enumerate(offsets):
            y = y + vals_loc[i][None, :] * xp[:, off + hl:off + hl + n_loc]
            if dm.sym and off > 0:
                vp = vexp[i, dmax - off:dmax - off + n_loc]
                y = y + vp[None, :] * xp[:, hl - off:hl - off + n_loc]
    elif partition == "n":
        vals_loc = _on_rank(dm, ("dia", r.tag),
                            lambda: slab(n_loc))
        lo = max(0, -dmin)
        hi = max(0, dmax + np_ - m)
        xp = F.pad(x2d, (lo, hi))
        c0 = me * n_loc
        if dm.sym and dmax:
            vexp = torch.cat([left_vals(vals_loc, dmax), vals_loc], dim=1)
        y = torch.zeros((b, n_loc), dtype=torch.float32, device=r.dev)
        for i, off in enumerate(offsets):
            s0 = c0 + off + lo
            y = y + vals_loc[i][None, :] * xp[:, s0:s0 + n_loc]
            if dm.sym and off > 0:
                vp = vexp[i, dmax - off:dmax - off + n_loc]
                s1 = c0 - off + lo
                y = y + vp[None, :] * xp[:, s1:s1 + n_loc]
    else:
        raise ValueError(f"unknown partition {partition!r}")
    y = _gather_cols(y, r)[:, :n]
    return y[0] if squeeze else y
