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
``work_plan`` cuts the stream, once per pack, into items: runs of
consecutive chunks with one ``cj``, at most ``per_item`` chunks each. A
block sums one item into a (B, 128) partial, and a second kernel adds each
group's partials in a fixed order (deterministic: no float atomics). Cutting
by equal ``cj`` rather than by position makes the plan right for any chunk
order: the pack's zero tail chunks (``cj = 0`` after the last group) and an
empty pack's one zero chunk become items of group 0 that add zeros. A
run-aligned pack (run = 8) and a flat pack (run = 1) go through the same
body: a run only says where a group's chunks end, which the items already
know.

``rsell_spmm`` launches the CUDA kernel for CUDA tensors and uses
``rsell_spmm_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.kernels import _build
from tpusparse_torch.utils import round_up

_LANES = 128
_SUB = 8
_ID_LIMIT = 0xFFFF

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


def device_work_plan(cj: np.ndarray, nb: int,
                     device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``work_plan`` with items sized so the partial kernel runs about
    eight blocks per SM (``_build.split_work``), as int32 tensors on the
    CUDA ``device``."""
    per_item, _ = _build.split_work(max(len(cj), 1), 1, device)
    items, gptr = work_plan(cj, nb, per_item)
    return (torch.from_numpy(items).to(device),
            torch.from_numpy(gptr).to(device))


def resolve_plan(name: str, plan, cj: torch.Tensor, nb: int,
                 dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``device_work_plan`` of ``cj`` for a wrapper: ``plan`` checked
    against ``nb`` output groups, or built here (from a host copy of cj)
    when None."""
    if plan is None:
        plan = device_work_plan(cj.cpu().numpy(), nb, dev)
    items, gptr = plan
    if items.dtype != torch.int32 or gptr.dtype != torch.int32 \
            or gptr.shape != (nb + 1,):
        raise ValueError(f"{name}: plan must be int32 (items, gptr) of "
                         "device_work_plan for this n_padded")
    _build.require_cuda(name, items, gptr)
    if items.device != dev:
        raise ValueError(f"{name}: plan on {items.device}, data on {dev}")
    return items, gptr


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
               plan: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> torch.Tensor:
    """K4: cj, ct (nchunk,) int32, idx (nchunk, 8, 128) int8, vals
    (nchunk, 8, 128) fp32, x (B, m) fp32 (columns past m read as 0) ->
    (B, n) fp32, n <= n_padded (default n_padded). ``plan``: the
    ``device_work_plan`` of ``cj``, built here (with a host copy of cj)
    when None."""
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
    dev = _build.require_cuda("rsell_spmm", ct, idx, vals, x,
                              aligned=(idx, vals))
    items, gptr = resolve_plan("rsell_spmm", plan, cj, nb, dev)
    batch, nitems = x.shape[0], items.shape[0]
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
