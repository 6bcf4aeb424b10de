"""Differentiable sparse linear maps, ``y = x @ A``, as
``torch.autograd.Function``s.

Counterpart of ``tpusparse/autodiff.py``. For a linear map the rule is
exact:

    y = x @ A        =>        dL/dx = g @ A.T        (g = dL/dy)

so the backward pass is another SpMV/SpMM, through a format packed from
``A.T``.

- ``linear_map`` freezes the packed values (a fixed operator: masked
  pruning, a graph's normalized adjacency) and differentiates in x only.
- ``trainable_linear`` trains the values of a frozen mask. It keeps the
  values in two tied layouts, the forward SELL pack and the pack of A.T,
  so the backward's ``dx`` streams the transpose values directly instead
  of permuting slots every step. Each copy gets the same gradient in its
  own layout from K10 (``kernels/sell_grad.py``), so any elementwise
  optimizer update keeps them tied up to rounding; ``resync`` re-ties
  ``vals_t`` from ``vals`` exactly.

- ``linear_map_sharded`` and ``trainable_linear_sharded`` are the same
  over a device mesh (``parallel``): one process a rank, every rank given
  the same x and returning the full y. Every rank computes the same loss
  from that y, so every rank holds the full cotangent g, and the backward
  needs no collective of its own beyond the dual partition's. The
  collectives (``parallel.comm``) build no autograd graph: the rule is
  written out, never differentiated through a gather (whose backward would
  sum the D identical copies of g).

The JAX package's ``statics=`` keyword exists for the TPU's remote compile
(its inline constants outgrew the payload limit); here the structure planes
are device tensors from construction and PyTorch runs eagerly, so it has
no counterpart.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.sell import (_sorted_rows, as_input,
                                          sell_pack_csr, sell_slot_flat)
from tpusparse_torch.kernels.sell_grad import sell_dvals
from tpusparse_torch.kernels.sell_spmv import sell_spmm
from tpusparse_torch.parallel import comm
from tpusparse_torch.parallel.mesh import axis_size, mesh_device
from tpusparse_torch.utils import resolve_device


def _run(f: Any, v: torch.Tensor) -> torch.Tensor:
    return f.spmv(v) if v.ndim == 1 else f.spmm(v)


class _LinearMap(torch.autograd.Function):
    """``x @ A`` through ``fmt``; the backward is ``g @ A.T`` through
    ``fmt_t``. The packed values are constants."""

    @staticmethod
    def forward(ctx, x, fmt, fmt_t):
        ctx.fmt_t = fmt_t
        return _run(fmt, x)

    @staticmethod
    def backward(ctx, g):
        return _run(ctx.fmt_t, g.contiguous()), None, None


def linear_map(fmt: Any, fmt_t: Any = None, *,
               csr: CsrMatrix | None = None) -> Callable[[Any], torch.Tensor]:
    """``apply(x) -> x @ A`` (1-D x: spmv, 2-D: row-batch spmm),
    differentiable in x; dx has x's shape.

    ``fmt``   — any packed format with spmv/spmm (SELL, AWSP, RSELL, TCSR,
       BSR, DIA, ASP).
    ``fmt_t`` — a format of the same API packed from ``A.T``, for the
       backward. Omitted: packed as ``type(fmt).from_csr(csr.transpose())``
       when ``csr`` (the CSR ``fmt`` was packed from) is given, else from
       ``fmt.to_dense().T`` (a host round trip; pass ``csr`` for matrices
       that should never be dense). Either lands on ``fmt``'s device.
    """
    if fmt_t is None:
        cls = type(fmt)
        if csr is not None:
            fmt_t = cls.from_csr(csr.transpose(), device=fmt.device)
        else:
            mm, nn = fmt.shape
            if mm * nn * 4 > 2 << 30:
                raise ValueError(
                    f"packing the backward transpose from a dense "
                    f"round-trip would allocate {mm * nn * 4 / 1e9:.1f} GB; "
                    "pass csr= (no-densify, O(nnz)) or a pre-packed fmt_t=")
            fmt_t = cls.from_dense(fmt.to_dense().T, device=fmt.device)
    m, n = fmt.shape
    if tuple(fmt_t.shape) != (n, m):
        raise ValueError(
            f"fmt_t.shape {tuple(fmt_t.shape)} is not the transpose of "
            f"fmt.shape {(m, n)}")

    def apply(x):
        return _LinearMap.apply(as_input(x, fmt.device), fmt, fmt_t)

    return apply


def _signed_idx(idx: np.ndarray,
                flat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(signed, mask)``: int8 in-window indices with pad slots forced to
    -1 (a zero pad would alias in-window offset 0 and leak cotangent),
    plus the live-slot boolean mask."""
    mask = np.zeros(idx.size, dtype=bool)
    mask[flat] = True
    mask = mask.reshape(idx.shape)
    return np.where(mask, idx, -1).astype(np.int8), mask


# vals of fewer slots than this re-tie through an int32 gather map; at and
# past it the map keeps int64 indices (int32 would wrap)
INT32_SLOTS = 1 << 31


class _TwinPack:
    """One packing pass for the twin-layout trainable paths, on the host.

    Sorts the CSR first (legal CSR does not guarantee within-row order, and
    every slot plane below assumes the packer's ranking), then packs both
    layouts (``sell_pack_csr`` dicts of host tensors), their live-slot
    maps and the signed idx planes."""

    def __init__(self, csr: CsrMatrix):
        self.csr = _sorted_rows(csr)
        self.csr_t = self.csr.transpose()            # O(nnz), computed once
        self.fmt = sell_pack_csr(self.csr)
        self.fmt_t = sell_pack_csr(self.csr_t)
        self.flat_f = sell_slot_flat(self.csr, self.fmt["w"])
        self.flat_t = sell_slot_flat(self.csr_t, self.fmt_t["w"])
        self.s_f, self.mask_f = _signed_idx(self.fmt["idx"].numpy(),
                                            self.flat_f)
        self.s_t, self.mask_t = _signed_idx(self.fmt_t["idx"].numpy(),
                                            self.flat_t)

    def retie_map(self) -> tuple[np.ndarray, np.ndarray]:
        """``(gather, live)`` in the transpose layout: transpose entry i is
        forward entry ``order[i]`` (``CsrMatrix.transpose``'s stable
        counting sort), so ``vals_t.ravel() = where(live,
        vals.ravel()[gather], 0)``."""
        order = np.argsort(self.csr.col_idx, kind="stable")
        t_map = np.full(self.s_t.size, -1, dtype=np.int64)
        t_map[self.flat_t] = self.flat_f[order]
        live = t_map >= 0
        np.maximum(t_map, 0, out=t_map)
        # int32 while every slot of vals has an int32 flat index
        gather = t_map.astype(np.int32) if self.s_f.size < INT32_SLOTS \
            else t_map
        return gather, live


def twin_params(pack: _TwinPack, dev: torch.device) -> tuple[dict, dict]:
    """What a product and its gradients need on the device: ``statics``
    (idx, idx_t, s_f, s_t) and ``params`` (vals, vals_t; no grad yet)."""
    def to(a):
        return torch.as_tensor(a).to(dev)

    return ({"idx": to(pack.fmt["idx"]), "idx_t": to(pack.fmt_t["idx"]),
             "s_f": to(pack.s_f), "s_t": to(pack.s_t)},
            {"vals": to(pack.fmt["vals"]), "vals_t": to(pack.fmt_t["vals"])})


def twin_leaves(pack: _TwinPack, dev: torch.device) -> dict[str, Any]:
    """The device tensors of a twin pack: ``statics`` and ``params`` (see
    ``twin_params``), ``masks``, the re-tie map (``gather``, ``live``,
    shaped as vals_t) and the matrix ``shape``."""
    statics, params = twin_params(pack, dev)
    gather, live = pack.retie_map()
    t_shape = pack.fmt_t["vals"].shape

    def to(a):
        return torch.as_tensor(a).to(dev)

    return {
        "statics": statics, "params": params,
        "masks": {"vals": to(pack.mask_f), "vals_t": to(pack.mask_t)},
        "gather": to(gather), "live": to(live.reshape(t_shape)),
        "shape": pack.fmt["shape"],
    }


def retied(vals: torch.Tensor, gather: torch.Tensor,
           live: torch.Tensor) -> torch.Tensor:
    """``vals_t`` re-derived from ``vals`` exactly: one gather on the
    device, no host sync."""
    flat = vals.detach().reshape(-1).index_select(0, gather)
    return torch.where(live, flat.reshape(live.shape), 0.0)


class TwinSell(torch.autograd.Function):
    """``y = x @ A`` over the twin SELL layouts, differentiable in both
    value copies and x (shape (..., m) -> (..., n)). Forward: K1 on
    ``(idx, vals)``. Backward: K1 on
    ``(idx_t, vals_t)`` for dx, K10 on ``s_f`` for ``vals`` and K10 on
    ``s_t`` with x and g swapped for ``vals_t`` (``tpusparse/autodiff.py:
    282-291``), each only where ``ctx.needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, vals, vals_t, x, statics, shape):
        ctx.statics, ctx.shape = statics, shape
        ctx.save_for_backward(vals_t, x)
        y = sell_spmm(statics["idx"], vals, x.reshape(-1, x.shape[-1])
                      .contiguous(), n=shape[1])
        return y.reshape(*x.shape[:-1], shape[1])

    @staticmethod
    def backward(ctx, gy):
        vals_t, x = ctx.saved_tensors
        st, (m, _) = ctx.statics, ctx.shape
        need_v, need_vt, need_x = ctx.needs_input_grad[:3]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        g2 = gy.reshape(-1, gy.shape[-1]).contiguous()
        dvals = sell_dvals(st["s_f"], x2, g2) if need_v else None
        dvals_t = sell_dvals(st["s_t"], g2, x2) if need_vt else None
        dx = sell_spmm(st["idx_t"], vals_t, g2, n=m).reshape(x.shape) \
            if need_x else None
        return dvals, dvals_t, dx, None, None


def trainable_linear(csr: CsrMatrix, device=None):
    """Sparse-weight training: ``apply(params, x) = x @ A``, differentiable
    in the packed SELL values and in x. ``device=None`` is the GPU.

    Returns ``(apply, params, masks, resync)``:
      - ``params = {"vals", "vals_t"}``: leaf tensors on the device that
        require grad, the values in the forward layout and in the transpose
        layout; tied copies of the same weights (module docstring). Pass
        ``params.values()`` to a ``torch.optim`` optimizer.
      - ``masks``: bool tensors of the same shapes, True on real slots. Pad
        slots get exactly zero gradient; an update that moves parameters
        without gradients (weight decay) must respect the mask itself: a
        nonzero pad would enter the product at in-window offset 0.
      - ``resync(params)`` re-ties ``vals_t`` from ``vals`` exactly, in
        place (the optimizer keeps its references), and returns
        ``params``.
      - ``apply.statics``: the structure planes ``idx``, ``idx_t``, ``s_f``,
        ``s_t`` on the device.
    """
    dev = resolve_device(device)
    leaves = twin_leaves(_TwinPack(csr), dev)
    statics, shape = leaves["statics"], leaves["shape"]
    gather, live = leaves["gather"], leaves["live"]
    params = {k: v.requires_grad_() for k, v in leaves["params"].items()}

    def apply(p, x):
        return TwinSell.apply(p["vals"], p["vals_t"], as_input(x, dev),
                              statics, shape)

    def resync(p):
        with torch.no_grad():
            p["vals_t"].copy_(retied(p["vals"], gather, live))
        return p

    apply.statics = statics
    return apply, params, leaves["masks"], resync


# an output-column shard of A is a contraction shard of A.T and vice versa;
# "ring" is self-dual, and so is "2d" (batch x output): the backward shards
# A.T's own output groups over the same dimension
_DUAL_PARTITION = {"n": "m", "m": "n", "ring": "ring", "2d": "2d"}


class _ShardedLinearMap(torch.autograd.Function):
    """``x @ A`` through ``parallel.sparse.sell_spmm_sharded``; the backward
    is ``g @ A.T`` through the same call on ``fmt_t`` under the dual
    partition. The packed values are constants."""

    @staticmethod
    def forward(ctx, x, fmt, fmt_t, mesh, partition, dual):
        from tpusparse_torch.parallel.sparse import sell_spmm_sharded

        ctx.args = (fmt_t, mesh, dual)
        return sell_spmm_sharded(fmt, x, mesh, partition)

    @staticmethod
    def backward(ctx, g):
        from tpusparse_torch.parallel.sparse import sell_spmm_sharded

        fmt_t, mesh, dual = ctx.args
        return (sell_spmm_sharded(fmt_t, g.contiguous(), mesh, dual),
                None, None, None, None, None)


def linear_map_sharded(fmt: Any, fmt_t: Any, mesh: Any,
                       partition: str = "n") -> Callable[[Any], torch.Tensor]:
    """Differentiable ``x @ A`` over a device mesh (SELL packs on the host;
    each rank uploads its own shard once, ``parallel.sparse``).

    The backward is ``g @ A.T`` under the dual partition: an output-column
    shard of A is a contraction shard of A.T (and vice versa), so forward
    ``n`` pairs with backward ``m`` (its partial sums summed over the
    group), and ``ring`` and ``2d`` are self-dual. The values are frozen,
    as in ``linear_map``. The result lies on the mesh's device."""
    m, n = fmt.shape
    if tuple(fmt_t.shape) != (n, m):
        raise ValueError(
            f"fmt_t.shape {tuple(fmt_t.shape)} is not the transpose of "
            f"fmt.shape {(m, n)}")
    if partition not in _DUAL_PARTITION:
        raise ValueError(f"unknown partition {partition!r}; supported: "
                         f"{sorted(_DUAL_PARTITION)}")
    dual = _DUAL_PARTITION[partition]
    dev = mesh_device(mesh)

    def apply(x):
        return _ShardedLinearMap.apply(as_input(x, dev), fmt, fmt_t, mesh,
                                       partition, dual)

    return apply


def _pad(a: np.ndarray, axis: int, d: int, value) -> np.ndarray:
    """Pad ``axis`` of a host array to a multiple of ``d`` with ``value``."""
    pad = -a.shape[axis] % d
    if not pad:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=value)


class _RankTwin:
    """One rank's planes of the twin layouts: its column groups of the
    forward pack (``idx``, the signed ``s_f``) and its n-windows of the
    transpose pack (``idx_t``, ``s_t``), each padded to a multiple of D (the
    signed planes with -1), sliced once and contiguous on the device."""

    def __init__(self, pack: _TwinPack, mesh, dev: torch.device):
        self.group = mesh.get_group("n")
        self.d, self.me = axis_size(mesh, "n"), mesh.get_local_rank("n")
        self.m, self.n = pack.fmt["shape"]
        nb = pack.fmt["vals"].shape[0]
        if pack.fmt_t["vals"].shape[1] != nb:
            raise AssertionError("the transpose pack's windows are not the "
                                 "forward pack's column groups")
        self.nbl = -(-nb // self.d)              # groups (and windows) a rank
        self.cut = slice(self.me * self.nbl, (self.me + 1) * self.nbl)
        self.dev = dev
        self.idx = self.groups(pack.fmt["idx"], 0)
        self.s_f = self.groups(pack.s_f, -1)
        self.idx_t = self.windows(pack.fmt_t["idx"], 0)
        self.s_t = self.windows(pack.s_t, -1)

    def groups(self, a, value) -> torch.Tensor:
        """The rank's column groups (axis 0) of a forward-layout plane."""
        return self._up(_pad(np.asarray(a), 0, self.d, value)[self.cut])

    def windows(self, a, value) -> torch.Tensor:
        """The rank's n-windows (axis 1) of a transpose-layout plane."""
        return self._up(_pad(np.asarray(a), 1, self.d, value)[:, self.cut])

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def cols(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a (B, n) cotangent: the output columns of
        its groups, which are the contraction rows of its windows of A.T."""
        if self.d == 1:
            return v
        width = self.d * self.nbl * 128
        v = torch.nn.functional.pad(v, (0, width - v.shape[1]))
        return v[:, self.cut.start * 128:self.cut.stop * 128].contiguous()


class _ShardedTwin(torch.autograd.Function):
    """``y = x @ A`` over one rank's shards of the twin layouts (the
    ``TwinSell`` rule under ``trainable_linear_sharded``'s plan):
    forward K1 on the rank's groups, y gathered; dx K1 on the rank's
    windows of A.T with its columns of g, summed over the group; ``dvals``
    K10 on its groups of ``s_f`` with its columns of g, ``dvals_t`` K10 on
    its windows of ``s_t`` with g and x swapped, neither with any
    communication."""

    @staticmethod
    def forward(ctx, vals, vals_t, x, rk):
        ctx.rk = rk
        ctx.save_for_backward(vals_t, x)
        y = sell_spmm(rk.idx, vals, x.reshape(-1, x.shape[-1]).contiguous())
        y = comm.all_gather_x(y, rk.group, axis=1)[:, :rk.n]
        return y.reshape(*x.shape[:-1], rk.n)

    @staticmethod
    def backward(ctx, gy):
        vals_t, x = ctx.saved_tensors
        rk = ctx.rk
        need_v, need_vt, need_x = ctx.needs_input_grad[:3]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        g_loc = rk.cols(gy.reshape(-1, gy.shape[-1]).contiguous())
        dvals = sell_dvals(rk.s_f, x2, g_loc) if need_v else None
        dvals_t = sell_dvals(rk.s_t, g_loc, x2) if need_vt else None
        dx = None
        if need_x:
            dx = comm.psum_y(sell_spmm(rk.idx_t, vals_t, g_loc, n=rk.m),
                             rk.group).reshape(x.shape)
        return dvals, dvals_t, dx, None


def trainable_linear_sharded(csr: CsrMatrix, mesh: Any, device=None):
    """Multi-rank sparse-weight training: ``trainable_linear`` with every
    pass partitioned over the mesh's ``"n"`` dimension (D ranks, one
    process each; call it on every rank with the same ``csr``).

    Plan (the JAX package's):
      - forward ``x @ A``: the ``n`` partition. Each rank runs K1 over its
        column groups of ``vals``; y is gathered, so every rank returns it
        whole;
      - ``dx = g @ A.T``: the dual ``m`` partition. Each rank runs K1 over
        its n-windows of ``vals_t`` and the partial dx are summed over the
        group;
      - ``dvals`` and ``dvals_t``: K10 on the rank's groups of ``s_f`` and
        windows of ``s_t``, from its own columns of the full g and the full
        x it already holds: no communication.

    Returns ``(apply, params, masks, resync)`` as ``trainable_linear``
    does, but ``params`` and ``masks`` are THIS RANK'S shards: ``vals``
    its column groups (axis 0), ``vals_t`` its n-windows (axis 1), both
    padded to a multiple of D (pad slots masked False, gradient exactly 0).
    A ``torch.optim`` optimizer on a rank updates that rank's shards; no
    gradient is averaged over ranks (do not wrap the model in
    ``DistributedDataParallel``). ``resync(params)`` re-ties the rank's
    ``vals_t`` windows from every rank's ``vals`` (one all-gather of the
    ``vals`` shards, then the re-tie gather), in place and bit for bit as
    the unsharded ``resync``. ``device=None`` is the mesh's device."""
    dev = mesh_device(mesh) if device is None else resolve_device(device)
    pack = _TwinPack(csr)
    rk = _RankTwin(pack, mesh, dev)
    params = {"vals": rk.groups(pack.fmt["vals"], 0).requires_grad_(),
              "vals_t": rk.windows(pack.fmt_t["vals"], 0).requires_grad_()}
    masks = {"vals": rk.groups(pack.mask_f, False),
             "vals_t": rk.windows(pack.mask_t, False)}
    gather, live = pack.retie_map()
    t_shape = pack.fmt_t["vals"].shape
    # vals_t's windows are re-tied from forward entries that other ranks
    # own: flat indices into the whole vals, which padding groups at its
    # end leaves where they were
    gather_l = rk.windows(gather.reshape(t_shape), 0).reshape(-1)
    live_l = rk.windows(live.reshape(t_shape), False)
    del pack

    def apply(p, x):
        return _ShardedTwin.apply(p["vals"], p["vals_t"], as_input(x, dev),
                                  rk)

    def resync(p):
        with torch.no_grad():
            full = comm.all_gather_x(p["vals"].detach(), rk.group, axis=0)
            p["vals_t"].copy_(retied(full, gather_l, live_l))
        return p

    apply.statics = {"idx": rk.idx, "idx_t": rk.idx_t, "s_f": rk.s_f,
                     "s_t": rk.s_t}
    return apply, params, masks, resync
