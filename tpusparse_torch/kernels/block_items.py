"""Part-tile work items of K6 (``bsr_spmv``) and K7 (``bsell_spmv``).

Both kernels walk a list of (rows x 128) tiles sorted by output group
``bj``: K6's BSR blocks (``block_m`` rows each), K7's block-SELL tiles (W
slot rows each). Seen as one stream of rows (row r is row r % tile_rows of
tile r // tile_rows, stored at r * 128), each group's tiles form one run.
``item_plan`` cuts every run into items ``(group, first row, end row)`` of
at most ``per_item`` rows, so that a pack of few tiles still gives the card
about as many blocks as it holds at once and a pack of many about one wave
(``item_rows``, as ``_build.launch_shape`` sizes K2's slices). One block
sums one item and batch tile into a (B, 128) partial, and a second kernel
adds each group's partials, ``items[gptr[j]:gptr[j+1]]``, in a fixed order
(``csrc/block_items.cuh``), so the items are sorted by group; a group with
no item gets zeros.

The plan is built on the host once per pack, one for each launch shape the
kernel has by batch tile (``device_plans``), and cut by equal ``bj`` rather
than by position, so any tile order is summed right.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpusparse_torch.kernels import _build

# rows of the stream are int32 in the plan and the kernels
ROW_LIMIT = 2**31 - 1


class ItemPlan(NamedTuple):
    items: torch.Tensor     # (nitems, 3) int32: group, first row, end row
    gptr: torch.Tensor      # (nb + 1,) int32: group j's items


def item_rows(total_rows: int, sms: int, resident: int, quantum: int) -> int:
    """Rows an item holds so that about ``sms`` x ``resident`` items cover
    ``total_rows``: a multiple of ``quantum``."""
    per, _ = _build.launch_shape(max(total_rows, 1), 1, sms * resident,
                                 quantum)
    return per


def item_plan(bj: np.ndarray, nb: int, tile_rows: int, per_item: int,
              max_tiles: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Host plan of a tile list: ``items`` (nitems, 3) int32 rows ``(group,
    first row, end row)``, sorted by group, each a run of at most
    ``per_item`` rows of consecutive tiles of one group (and, when
    ``max_tiles`` > 0, of at most that many tiles); ``gptr`` (nb + 1,)
    int32, the items of group j being ``items[gptr[j]:gptr[j+1]]``."""
    bj = np.asarray(bj, dtype=np.int64)
    if bj.size and (bj.min() < 0 or bj.max() >= nb):
        raise ValueError(f"tile groups must lie in [0, {nb})")
    if bj.size * tile_rows > ROW_LIMIT:
        raise ValueError(f"{bj.size} tiles of {tile_rows} rows pass the "
                         f"int32 row ids of the work plan")
    if max_tiles > 0:       # rows o .. o+L-1 touch <= ceil((L-1)/T) + 1 tiles
        per_item = min(per_item, (max_tiles - 1) * tile_rows + 1)
    per_item = max(per_item, 1)
    items = np.zeros((0, 3), np.int64)
    if bj.size:
        start = np.flatnonzero(np.r_[True, bj[1:] != bj[:-1]])
        end = np.r_[start[1:], bj.size]
        rs, re = start * tile_rows, end * tile_rows
        pieces = -(-(re - rs) // per_item)
        seg = np.repeat(np.arange(start.size), pieces)
        first = np.repeat(np.cumsum(pieces) - pieces, pieces)
        r0 = rs[seg] + (np.arange(seg.size) - first) * per_item
        items = np.stack([bj[start[seg]], r0,
                          np.minimum(r0 + per_item, re[seg])], axis=1)
    items = items[np.argsort(items[:, 0], kind="stable")].astype(np.int32)
    gptr = np.searchsorted(items[:, 0], np.arange(nb + 1)).astype(np.int32)
    return items, gptr


def plans(bj: np.ndarray, nb: int, tile_rows: int, sms: int,
          shapes: dict[int, tuple[int, int]], max_tiles: int = 0
          ) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """``item_plan`` for each batch tile of ``shapes`` ({batch tile:
    (blocks resident an SM, row quantum)}) on a card of ``sms`` SMs."""
    total = len(bj) * tile_rows
    made: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    out = {}
    for bt, (resident, quantum) in shapes.items():
        per = item_rows(total, sms, resident, quantum)
        if per not in made:
            made[per] = item_plan(bj, nb, tile_rows, per, max_tiles)
        out[bt] = made[per]
    return out


def device_plans(bj: np.ndarray, nb: int, tile_rows: int,
                 device: torch.device, shapes: dict[int, tuple[int, int]],
                 max_tiles: int = 0) -> dict[int, ItemPlan]:
    """``plans`` for the CUDA ``device``, as int32 tensors there (batch
    tiles with the same items share them)."""
    return upload(plans(bj, nb, tile_rows, _build.sm_count(device), shapes,
                        max_tiles), device)


def upload(host: dict[int, tuple[np.ndarray, np.ndarray]],
           device: torch.device) -> dict[int, ItemPlan]:
    """Host plans by batch tile as int32 tensors on ``device`` (batch tiles
    with the same items share them)."""
    made: dict[int, ItemPlan] = {}
    out = {}
    for bt, (items, gptr) in host.items():
        if id(items) not in made:
            made[id(items)] = ItemPlan(torch.from_numpy(items).to(device),
                                       torch.from_numpy(gptr).to(device))
        out[bt] = made[id(items)]
    return out


def check_rows(name: str, ntiles: int, tile_rows: int) -> None:
    """Refuse a pack whose stream of rows passes the plan's int32 ids."""
    if ntiles * tile_rows > ROW_LIMIT:
        raise ValueError(f"{name}: {ntiles} tiles of {tile_rows} rows pass "
                         f"the work plan's int32 row ids")


def check_smem(name: str, need: int, limit: int) -> None:
    """Refuse a launch whose block needs more shared memory than ``limit``
    (``_build.smem_limit``)."""
    if need > limit:
        raise ValueError(f"{name}: a block needs {need} bytes of shared "
                         f"memory, the card allows {limit}")


def resolve(name: str, plan, bj: torch.Tensor, nb: int, tile_rows: int,
            bt: int, dev: torch.device, shapes: dict[int, tuple[int, int]],
            max_tiles: int = 0, cols: int = 3) -> ItemPlan:
    """The plan of batch tile ``bt`` for a wrapper: from ``plan`` (the
    ``device_plans`` of the pack, items of ``cols`` int32 each), checked
    against ``nb`` groups, or built here from a host copy of bj when
    None."""
    if plan is None:
        plan = device_plans(bj.cpu().numpy(), nb, tile_rows, dev, shapes,
                            max_tiles)
    if not isinstance(plan, dict) or not isinstance(plan.get(bt), ItemPlan):
        raise ValueError(f"{name}: plan must be the device_plans of the "
                         f"pack, {{batch tile: ItemPlan}}")
    items, gptr = plan[bt]
    if items.dtype != torch.int32 or gptr.dtype != torch.int32 \
            or items.ndim != 2 or items.shape[1] != cols \
            or gptr.shape != (nb + 1,):
        raise ValueError(f"{name}: plan must be int32 (items, gptr) of "
                         "device_plans for this n_padded")
    _build.require_cuda(name, items, gptr)
    if items.device != dev:
        raise ValueError(f"{name}: plan on {items.device}, data on {dev}")
    return plan[bt]
