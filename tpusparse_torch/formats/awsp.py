"""AWSP: SELL weight compression + activation window-group-skip plan.

Counterpart of ``tpusparse/formats/awsp.py`` with the same packed layout.
A is packed once with the SELL packer; each product visits only the
G·128-row m-window groups where X has any nonzero (kernels/awsp_spmv.py).

Padding convention: the window axis is padded to a multiple of G, then one
extra all-zero GROUP is appended (group index ``ng``); plan padding and an
all-zero X both point there.

Plans. The JAX package picks the plan by whether X is concrete or traced;
here a CUDA tensor stands in for "traced", because fetching it to build a
host plan would sync:

- ``plan=None`` with host data (numpy, or a CPU tensor): the exact host plan
  of ``plan()``, uploaded to the matrix's device;
- ``plan=None`` with a CUDA tensor, or ``plan="device"``: the device plan
  (``device_group_plan``): activity mask, compacted ids and the active count
  stay on the device and the kernel reads the count there — no host sync;
- an explicit plan (array or tensor of group ids): used as given.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.sell import (SellMatrix, _lane, as_input,
                                          sell_pack, sell_pack_csr)
from tpusparse_torch.utils import resolve_device, round_up

_LANES = 128


class PlanSkip:
    """Plan machinery shared by the activation-skipping formats: AWSP skips
    window groups of ``span = g*128`` rows, ASP single 128-row windows.
    A subclass gives ``n_units`` (real skippable units), ``span``,
    ``device``, ``plan(x)`` (the exact host plan) and ``_product(xt, plan,
    k)`` (the kernel call); plan ``n_units`` is the all-zero unit."""

    n_units: int
    span: int

    def _full_plan(self) -> torch.Tensor:
        """Every unit, as a device tensor (uploaded once, then cached)."""
        if self._full is None:
            self._full = torch.arange(self.n_units, dtype=torch.int32,
                                      device=self.device)
        return self._full

    def _count(self, na: int) -> torch.Tensor:
        """Device int32 scalar ``na`` for a static plan (uploaded once)."""
        if na not in self._counts:
            self._counts[na] = torch.full((1,), na, dtype=torch.int32,
                                          device=self.device)
        return self._counts[na]

    def _run(self, x2d, plan: Any = None) -> torch.Tensor:
        from tpusparse_torch.kernels.awsp_spmv import device_group_plan

        on_card = isinstance(x2d, torch.Tensor) and x2d.device.type == "cuda"
        if isinstance(plan, str):
            if plan != "device":
                raise ValueError(f"plan={plan!r}: expected 'device'")
        elif plan is None and not on_card:
            plan = self.plan(x2d)
        # no padding to the packed rows: the kernel reads them as zero
        xt = as_input(x2d, self.device).contiguous()
        if plan is None or isinstance(plan, str):
            plan_t, k = device_group_plan(xt, self.n_units, self.span)
        else:
            if not isinstance(plan, torch.Tensor):
                p = np.asarray(plan)
                if p.ndim != 1 or p.size == 0 or p.min() < 0 \
                        or p.max() > self.n_units:
                    raise ValueError(f"plan must list ids in "
                                     f"[0, {self.n_units}], got {p}")
            plan_t = torch.as_tensor(plan, dtype=torch.int32,
                                     device=self.device)
            k = self._count(int(plan_t.numel()))
        return self._product(xt, plan_t, k)

    def spmv(self, x, plan: Any = None) -> torch.Tensor:
        """x: (m,) -> (n,). ``plan``: see the module docstring."""
        if isinstance(x, torch.Tensor):
            return self._run(x[None, :], plan=plan)[0]
        return self._run(np.asarray(x)[None, :], plan=plan)[0]

    def spmm(self, x, plan: Any = None) -> torch.Tensor:
        """x: (b, m) -> (b, n). ``plan``: see the module docstring."""
        return self._run(x, plan=plan)


class AwspMatrix(PlanSkip):
    """AWSP-packed A held as tensors on one device."""

    def __init__(self, idx: torch.Tensor, vals: torch.Tensor, shape, padded,
                 w: int, g: int, nnz: int):
        self.idx = idx              # (nb, (ng+1)*G, W, 128) int8
        self.vals = vals            # (nb, (ng+1)*G, W, 128) fp32 / bf16
        self.shape = tuple(shape)
        self.padded = tuple(padded)  # (mp, np) BEFORE group padding
        self.w = w
        self.g = g                  # windows per skippable group
        self.nnz = nnz
        self._counts: dict[int, torch.Tensor] = {}   # plan length -> count
        self._full: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @classmethod
    def _from_pack(cls, p: dict, g: int, device=None) -> "AwspMatrix":
        dev = resolve_device(device)
        nt = p["vals"].shape[1]
        extra = round_up(nt, g) - nt + g        # align to G + 1 zero group

        def pad(t: torch.Tensor) -> torch.Tensor:
            z = t.new_zeros((t.shape[0], extra) + tuple(t.shape[2:]))
            return torch.cat([t, z], dim=1).to(dev)

        return cls(pad(p["idx"]), pad(p["vals"]), p["shape"], p["padded"],
                   p["w"], g, p["nnz"])

    def __repr__(self) -> str:
        return (f"AwspMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"w={self.w}, g={self.g}, groups={self.n_groups}, "
                f"device={self.device}, {self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_dense(cls, a, w: int | None = None, g: int = 1,
                   dtype: Any = None, device=None) -> "AwspMatrix":
        """``g``: windows per skippable group (skip granularity g*128 rows).
        ``dtype``: None/float32 or bfloat16 value storage."""
        if _lane(dtype) == "int8":
            raise ValueError("AwspMatrix has no int8 lane (no scales)")
        resolve_device(device)
        return cls._from_pack(sell_pack(a, w=w, dtype=dtype), g, device)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, w: int | None = None, g: int = 1,
                 device=None) -> "AwspMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        resolve_device(device)
        return cls._from_pack(sell_pack_csr(csr, w=w), g, device)

    @property
    def n_groups(self) -> int:
        """Number of real (non-padding) window groups."""
        return self.vals.shape[1] // self.g - 1

    def device_bytes(self, x=None) -> int:
        """Bytes the kernel streams: all groups, or only X-active ones."""
        nb, _, wd, lanes = self.vals.shape
        na = self.n_groups if x is None else len(self.plan(x))
        return nb * na * self.g * wd * lanes * (self.vals.element_size() + 1)

    def to_dense(self) -> torch.Tensor:
        nt = self.padded[0] // _LANES
        return SellMatrix(self.idx[:, :nt], self.vals[:, :nt], self.shape,
                          self.padded, self.w, self.nnz).to_dense()

    def plan(self, x2d) -> np.ndarray:
        """Exact host plan: active-group ids for this activation (the zero
        group if none). ``x2d``: numpy or a tensor (fetched to the host)."""
        x2d = x2d.detach().cpu().numpy() if isinstance(x2d, torch.Tensor) \
            else np.asarray(x2d)
        if x2d.ndim == 1:
            x2d = x2d[None, :]
        m = self.shape[0]
        ng = self.n_groups
        rows = ng * self.g * _LANES
        xw = np.zeros(rows, dtype=bool)
        xw[:m] = (x2d[:, :m] != 0).any(axis=0)
        active = np.nonzero(xw.reshape(ng, self.g * _LANES).any(axis=1))[0]
        if active.size == 0:
            active = np.array([ng])
        return active.astype(np.int32)

    @property
    def n_units(self) -> int:
        return self.n_groups

    @property
    def span(self) -> int:
        return self.g * _LANES

    def _product(self, xt: torch.Tensor, plan: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
        from tpusparse_torch.kernels.awsp_spmv import awsp_spmm

        return awsp_spmm(plan, k, self.idx, self.vals, xt, g=self.g,
                         n=self.shape[1])
