"""Smoothed-aggregation algebraic multigrid.

Counterpart of ``tpusparse/amg.py`` (Vanek/Mandel/Brezina '96), one
device:

- **Setup is on the host**, numpy and scipy in float64, the JAX package's
  code: strength-spectrum ``theta`` (``_auto_theta``), Vanek's 3-pass
  aggregation (``_aggregate``, through the native converter where it
  built), the power-iteration ``lmax`` of ``D⁻¹A`` (``_lmax_dinv_a``, a
  seeded numpy generator), lattice detection (``_detect_grid``), tentative
  and Jacobi-smoothed prolongators and Galerkin products. Its output is
  bit-identical to the JAX package's. ``host_hierarchy`` returns it.
- **The cycle is on the device**: each level's operator and the greedy
  levels' ``P`` / ``Pᵀ`` carriers are packed (``_pack``: ``auto_format``
  for the square operators, which gives DIA (K8) or TCSR (K6/K7) on the
  Laplacian's levels; RSELL unsorted (K4) for the carriers; dense below
  ``dense_cutoff``), smoothing is the Chebyshev polynomial smoother (pure
  operator applications), "grid" and "block" levels transfer by
  reshape-sums and one extra operator application, and the coarsest
  level is a precomputed dense inverse applied as ``r @ coarse_inv`` (a
  ``torch.matmul``, as it is a plain product in the JAX package).
- The V-cycle is symmetric (the same polynomial before and after,
  Galerkin operators, an exact coarse solve), so it is a valid ``m_inv``
  for ``solve.cg``; ``solve`` is that CG.

``save``/``load`` write and read the JAX package's checkpoint (a manifest
and ``formats.io``-encoded packs), so a hierarchy built in either package
loads in the other. The JAX package's TPU upload helpers have no
counterpart.

Across ranks (``parallel``, one process a rank) the level vectors stay
whole on every rank and each operator apply computes the rank's slab and
gathers y, so the V-cycle's vector operations, and CG's dot products and
stopping test, run alike on every rank:

- ``smoothed_aggregation(..., mesh=mesh)`` packs each greedy level above
  ``dense_cutoff`` (its operator and both carriers) as contiguous
  ragged-SELL column shards (``_ShardedOp``: K4 on the rank's shard, no
  unpermute), then places the rest with ``shard``;
- ``shard(mesh)`` runs each grid or block level's DIA operator through the
  halo partition (``parallel.sparse.dia_spmm_sharded``: K8 with halo strips
  where its rule holds) when the level's n divides by D; dense levels, the
  grid and block transfers, ``dinv`` and the coarse inverse are
  replicated. It refuses a greedy hierarchy packed for one device.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.utils import resolve_device


def _auto_theta(sp) -> float:
    """The drop tolerance from the distribution of normalized couplings
    ``s_ij = |a_ij| / sqrt(a_ii a_jj)``: 0 for a unimodal spectrum
    (isotropic operators); for a bimodal one (a weak cluster below S/4
    holding >= 25% of the off-diagonals, its median a decade below S, S
    the median per-row strongest coupling) S/4 clipped to [0.02, 0.25],
    which semicoarsens along the strong direction."""
    n = sp.shape[0]
    indptr, indices, data = sp.indptr, sp.indices, np.abs(sp.data)
    diag = np.abs(sp.diagonal()) + 1e-300
    rows = np.repeat(np.arange(n), np.diff(indptr))
    off = indices != rows
    if not off.any():
        return 0.0
    s = data[off] / np.sqrt(diag[rows[off]] * diag[indices[off]])
    row_max = np.zeros(n)
    np.maximum.at(row_max, rows[off], s)
    strong_typ = float(np.median(row_max[row_max > 0]))
    if strong_typ <= 0:
        return 0.0
    weak = s[s < strong_typ / 4]
    if weak.size < 0.25 * s.size:
        return 0.0
    weak_typ = float(np.median(weak))
    if weak_typ > strong_typ / 10:
        return 0.0
    return float(np.clip(strong_typ / 4, 0.02, 0.25))


def _aggregate(sp, theta: float,
               use_native: bool | None = None) -> tuple[np.ndarray, int]:
    """Standard aggregation (Vanek '96, 3 passes) on the strength graph
    ``|a_ij| >= theta * sqrt(a_ii * a_jj)``: (aggregate ids, n_agg).
    Greedy in node order, so sequential; the native converter
    (``amg_aggregate``) gives the same ids ~100x faster at 1M nodes."""
    n = sp.shape[0]
    indptr, indices, data = sp.indptr, sp.indices, np.abs(sp.data)
    diag = np.abs(sp.diagonal()) + 1e-300
    if use_native is not False:
        from tpusparse_torch import native

        res = native.amg_aggregate(indptr, indices, data, diag, theta)
        if res is not None:
            return res
        if use_native:
            raise RuntimeError("native converters requested but unavailable")
    # strength mask per stored entry (off-diagonal, above threshold)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    strong = (indices != rows) & \
        (data >= theta * np.sqrt(diag[rows] * diag[indices]) + 1e-300)

    agg = np.full(n, -1, np.int64)
    next_id = 0
    # pass 1: seed aggregates from fully-unaggregated strong neighborhoods
    for i in range(n):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl][strong[sl]]
        if (agg[nbrs] == -1).all():
            agg[i] = next_id
            agg[nbrs] = next_id
            next_id += 1
    # pass 2: attach leftovers to the strongest adjacent aggregate
    # (decided against the pass-1 state so attachments don't chain)
    pass1 = agg.copy()
    for i in range(n):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl][strong[sl]]
        w = data[sl][strong[sl]]
        hit = pass1[nbrs] != -1
        if hit.any():
            agg[i] = pass1[nbrs[hit][np.argmax(w[hit])]]
    # pass 3: remaining nodes form aggregates of what's left around them
    for i in range(n):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl][strong[sl]]
        grp = np.concatenate([[i], nbrs[agg[nbrs] == -1]])
        agg[grp] = next_id
        next_id += 1
    return agg, next_id


def _lmax_dinv_a(sp, dinv: np.ndarray, iters: int = 20,
                 seed: int = 0) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) (host, float64)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=sp.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (sp @ v)
        lam = np.linalg.norm(w)
        if lam == 0.0:
            return 1.0
        v = w / lam
    return float(lam)


_GRID_HALO = 4       # max stencil half-width accepted as "still a lattice"


def _detect_grid(sp) -> int | None:
    """Row stride ``C`` when ``sp`` is a lattice stencil on a row-major
    ``(R, C)`` grid (every nonzero offset is ``a + b*C`` with
    ``|a|, |b| <= _GRID_HALO``), else None. Among the candidate strides
    around the smallest offset past the halo, the one whose decomposition
    has the smallest sum of ``|a| + |b|`` wins (ties: the larger C)."""
    n = sp.shape[0]
    if sp.nnz == 0:
        return None
    rows = np.repeat(np.arange(n), np.diff(sp.indptr))
    offs = np.unique(sp.indices - rows)
    pos = offs[offs > _GRID_HALO]
    if pos.size == 0:
        return None
    h = _GRID_HALO
    best = None
    for c in range(max(int(pos.min()) - h, 2), int(pos.min()) + h + 1):
        if n % c or n // c < 4:
            continue
        b = np.rint(offs / c).astype(np.int64)
        a = offs - b * c
        if np.abs(a).max() <= min(h, (c - 1) // 2) and np.abs(b).max() <= h:
            score = (int(np.abs(a).sum() + np.abs(b).sum()), -c)
            if best is None or score < best[0]:
                best = (score, c)
    return best[1] if best else None


@dataclasses.dataclass
class HostLevel:
    """One level of the host hierarchy (float64): the operator ``sp``, the
    transfer ``kind`` ("packed": greedy aggregates and a smoothed
    prolongator ``p``; "block" / "grid": consecutive / lattice-block
    aggregates), the aggregate ids, ``dinv`` and ``lmax`` of ``D⁻¹A``."""

    sp: Any
    kind: str
    agg: np.ndarray
    n_agg: int
    p: Any
    dinv: np.ndarray
    lmax: float
    shape2d: tuple | None = None
    block_size: int | None = None


def _symmetric_csr(a, sym_tol: float):
    from scipy import sparse as ssp

    if isinstance(a, CsrMatrix):
        sp = a.to_scipy().tocsr().astype(np.float64)
    elif ssp.issparse(a):
        sp = a.tocsr().astype(np.float64)
    else:
        sp = ssp.csr_matrix(np.asarray(a, np.float64))
    if sp.shape[0] != sp.shape[1]:
        raise ValueError(f"AMG needs a square matrix, got {sp.shape}")
    asym = abs(sp - sp.T)
    if asym.nnz and asym.max() > sym_tol * max(abs(sp).max(), 1e-300):
        raise ValueError("AMG requires a symmetric matrix "
                         f"(max|A - A.T| = {asym.max():.3g})")
    return sp


def host_hierarchy(a, *, theta: float | str = "auto",
                   coarse_size: int = 400, max_levels: int = 12,
                   omega: float = 4.0 / 3.0, aggregation: str = "auto",
                   block_size: int = 8, grid_block: int = 3,
                   sym_tol: float = 1e-6):
    """The host half of ``smoothed_aggregation`` (see there for the
    arguments): ``(levels, coarse, theta_resolved)``, a list of
    ``HostLevel``, the coarsest operator (scipy, float64) and the finest
    greedy level's theta (0.0 when no level was greedy)."""
    from scipy import sparse as ssp

    sp = _symmetric_csr(a, sym_tol)
    if aggregation not in ("auto", "greedy", "block", "grid"):
        raise ValueError(f"aggregation must be auto|greedy|block|grid, "
                         f"got {aggregation!r}")

    levels: list[HostLevel] = []
    theta_resolved = None if theta == "auto" else float(theta)
    while sp.shape[0] > coarse_size and len(levels) < max_levels - 1:
        n = sp.shape[0]
        diag = sp.diagonal()
        dinv_h = 1.0 / np.where(np.abs(diag) > 1e-300, diag, 1.0)
        lmax = _lmax_dinv_a(sp, dinv_h)

        mode = aggregation
        grid_c = _detect_grid(sp) if mode == "grid" else None
        if mode == "auto":
            rows = np.repeat(np.arange(n), np.diff(sp.indptr))
            bw = int(np.abs(sp.indices - rows).max()) if sp.nnz else 0
            # greedy on lattices (its packed carriers beat grid's extra
            # operator applies); 1-D strips only on truly narrow,
            # contiguous bands (chains, ODE stencils)
            if n >= 4096 and bw <= 2 * block_size:
                offs = np.unique(sp.indices - rows)
                contiguous = offs.size == int(offs.max() - offs.min()) + 1
                if not contiguous and _detect_grid(sp) is not None:
                    mode = "greedy"
                else:
                    mode = "block"
            else:
                mode = "greedy"
        shape2d = None
        if mode == "grid":
            if grid_c is None:
                raise ValueError("aggregation='grid' but no row-major "
                                 "lattice structure detected")
            gs = grid_block
            shape2d = (n // grid_c, grid_c, gs)
            r0, c0 = np.divmod(np.arange(n), grid_c)
            cc = -(-grid_c // gs)
            agg = (r0 // gs) * cc + (c0 // gs)
            n_agg = (-(-shape2d[0] // gs)) * cc
        elif mode == "block":
            agg = np.arange(n) // block_size
            n_agg = int(agg[-1]) + 1
        else:
            lvl_theta = _auto_theta(sp) if theta == "auto" else theta
            if theta_resolved is None:
                theta_resolved = lvl_theta       # finest greedy level's pick
            agg, n_agg = _aggregate(sp, lvl_theta)
            if n_agg >= n:        # aggregation stalled (all singletons)
                break
        # tentative prolongator: unit-normalized aggregate indicators
        counts = np.bincount(agg, minlength=n_agg).astype(np.float64)
        p0 = ssp.csr_matrix(
            (1.0 / np.sqrt(counts[agg]), (np.arange(n), agg)),
            shape=(n, n_agg))
        # Jacobi smoothing: P = (I - omega/lmax D^-1 A) P0
        da = ssp.diags(dinv_h * (omega / max(lmax, 1e-30))) @ sp
        p = (p0 - da @ p0).tocsr()
        levels.append(HostLevel(
            sp, "packed" if mode == "greedy" else mode, agg, int(n_agg), p,
            dinv_h, lmax, shape2d, block_size if mode == "block" else None))
        sp = (p.T @ sp @ p).tocsr()

    if sp.shape[0] > max(4 * coarse_size, 8192):
        # refuse rather than densify and invert a large remainder
        raise ValueError(
            f"coarsening stalled at n={sp.shape[0]:,} (coarse_size="
            f"{coarse_size}): every node became a singleton or max_levels"
            f"={max_levels} ran out. Lower theta (strength threshold), "
            f"raise max_levels, or raise coarse_size.")
    return levels, sp, theta_resolved if theta_resolved is not None else 0.0


def _apply(op, v: torch.Tensor) -> torch.Tensor:
    """``v -> v @ op`` for a dense tensor or a packed format."""
    if isinstance(op, torch.Tensor):
        return v @ op
    return op.spmv(v)


class _ShardedOp:
    """A level operator or prolongator carrier as CONTIGUOUS ragged-SELL
    column shards over a mesh (``formats.rsell.rsell_shard_pack(...,
    assignment="contiguous")``, the JAX package's pack bit for bit): rank d
    owns output columns [d * cps, (d + 1) * cps) and uploads only its own
    shard, once, at construction. ``spmv`` is K4 on that shard and a
    gather of y (``parallel.sparse.rsell_spmm_sharded``); contiguous shards
    need no output permutation."""

    def __init__(self, shards, mesh):
        from tpusparse_torch.parallel.sparse import rsell_rank_shard

        self.shards, self.mesh = shards, mesh
        self.shape, self.nnz = shards.shape, int(shards.nnz)
        rsell_rank_shard(shards, mesh)

    @property
    def n_shards(self) -> int:
        return self.shards.n_shards

    @classmethod
    def from_scipy(cls, sp, mesh) -> "_ShardedOp":
        from tpusparse_torch.formats.rsell import rsell_shard_pack
        from tpusparse_torch.parallel.mesh import axis_size

        csr = CsrMatrix.from_scipy(sp.astype(np.float32))
        return cls(rsell_shard_pack(csr, axis_size(mesh, "n"),
                                    assignment="contiguous"), mesh)

    def spmv(self, v: torch.Tensor) -> torch.Tensor:
        from tpusparse_torch.parallel.sparse import rsell_spmm_sharded

        return rsell_spmm_sharded(self.shards, v, self.mesh)

    def device_bytes(self) -> int:
        """The bytes of every rank's shard together (the chunk streams)."""
        return sum(int(np.asarray(getattr(self.shards, k)).nbytes)
                   for k in ("cj", "ct", "idx", "vals"))

    def __repr__(self) -> str:
        return (f"_ShardedOp(shape={self.shape}, nnz={self.nnz}, "
                f"D={self.n_shards})")


class _HaloDia:
    """A DIA level operator over a mesh: each apply is the halo partition
    (``parallel.sparse.dia_spmm_sharded(dm, v, mesh, "halo")``), the rank's
    slab of y from its slab of v and its neighbours' edges, then y
    gathered."""

    def __init__(self, dm, mesh):
        self.dm, self.mesh = dm, mesh
        self.shape, self.nnz = dm.shape, dm.nnz

    def spmv(self, v: torch.Tensor) -> torch.Tensor:
        from tpusparse_torch.parallel.sparse import dia_spmm_sharded

        return dia_spmm_sharded(self.dm, v, self.mesh, "halo")

    def __repr__(self) -> str:
        return f"_HaloDia({self.dm!r})"


class _Level:
    """One device level: operator ``a`` (a pack or a dense tensor),
    transfers ``p`` / ``pt`` (greedy: packed carriers of ``P`` and ``Pᵀ``;
    grid: the per-node weights, ``pt`` None; block: the ``(nc, s)`` weight
    table, ``pt`` None), ``dinv`` (fp32 tensor) and ``lmax`` (the fp32
    value as a float)."""

    def __init__(self, a, p, pt, dinv, lmax, n: int, nnz: int, fmt: str,
                 kind: str = "packed", shape2d=None):
        self.a, self.p, self.pt = a, p, pt
        self.dinv, self.lmax = dinv, lmax
        self.n, self.nnz, self.fmt, self.kind = n, nnz, fmt, kind
        self.shape2d = shape2d

    def apply_a(self, v: torch.Tensor) -> torch.Tensor:
        """``v -> A v`` for this level's operator."""
        return _apply(self.a, v)


class SmoothedAggregationAMG:
    """One V-cycle per call: a symmetric positive definite approximation
    of ``A⁻¹``, an ``m_inv`` for ``solve.cg`` (``solve`` is that CG).
    Build with :func:`smoothed_aggregation`."""

    def __init__(self, levels, coarse_inv: torch.Tensor, theta: float,
                 degree: int, ratio: float, omega: float = 4.0 / 3.0,
                 mesh=None):
        self.levels = tuple(levels)
        self.mesh = mesh                 # set by ``shard``
        self.coarse_inv = coarse_inv
        self.theta = theta
        self.degree = degree
        self.ratio = ratio
        self.omega = omega

    @property
    def device(self) -> torch.device:
        return self.coarse_inv.device

    @property
    def operator_complexity(self) -> float:
        return sum(lv.nnz for lv in self.levels) / max(self.levels[0].nnz, 1)

    @property
    def grid_complexity(self) -> float:
        return sum(lv.n for lv in self.levels) / max(self.levels[0].n, 1)

    def __repr__(self) -> str:
        tag = {"block": "|blk", "grid": "|grid"}
        rows = ", ".join(
            f"{lv.n}({lv.fmt}{tag.get(lv.kind, '')},"
            f"nnz={lv.nnz})" for lv in self.levels)
        return (f"SmoothedAggregationAMG(levels=[{rows}], "
                f"op_cx={self.operator_complexity:.2f}, "
                f"grid_cx={self.grid_complexity:.2f}, "
                f"degree={self.degree})")

    # -- the cycle -----------------------------------------------------
    def _smooth(self, lev: _Level, r: torch.Tensor) -> torch.Tensor:
        """Chebyshev smoother ``z ~ A⁻¹ r`` over [lmax/ratio, 1.05 lmax]
        of ``D⁻¹A`` (``solve.chebyshev_preconditioner``'s recurrence)."""
        lmax = 1.05 * lev.lmax
        lmin = lev.lmax / self.ratio
        theta = (lmax + lmin) / 2.0
        delta = (lmax - lmin) / 2.0
        sigma = theta / delta
        v = lev.dinv * r
        rho = 1.0 / sigma
        d = v / theta
        z = d
        res = v - lev.dinv * _apply(lev.a, z)
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
            z = z + d
            res = res - lev.dinv * _apply(lev.a, d)
            rho = rho_new
        return z

    def _p0t(self, lev: _Level, v: torch.Tensor) -> torch.Tensor:
        """``P0ᵀ v``: the weighted aggregate sum, no carrier."""
        if lev.kind == "grid":
            R, C, s = lev.shape2d
            g = (v * lev.p).reshape(R, C)
            if R % s or C % s:
                g = F.pad(g, (0, -C % s, 0, -R % s))
            return g.reshape(-(-R // s), s, -(-C // s), s) \
                .sum(dim=(1, 3)).reshape(-1)
        w0 = lev.p                       # block: (nc, s) weight table
        v = F.pad(v, (0, w0.shape[0] * w0.shape[1] - lev.n))
        return (v.reshape(w0.shape) * w0).sum(dim=1)

    def _p0(self, lev: _Level, e: torch.Tensor) -> torch.Tensor:
        """``P0 e``: the weighted aggregate broadcast, no carrier."""
        if lev.kind == "grid":
            R, C, s = lev.shape2d
            rc, cc = -(-R // s), -(-C // s)
            u = e.reshape(rc, 1, cc, 1).expand(rc, s, cc, s)
            return u.reshape(s * rc, s * cc)[:R, :C].reshape(-1) * lev.p
        return (e[:, None] * lev.p).reshape(-1)[:lev.n]

    def _restrict(self, lev: _Level, r: torch.Tensor) -> torch.Tensor:
        if lev.kind == "packed":
            return _apply(lev.p, r)
        # Pᵀ r = P0ᵀ (r − (ω/λ) A d⁻¹ r)
        rs = r - (self.omega / lev.lmax) * _apply(lev.a, lev.dinv * r)
        return self._p0t(lev, rs)

    def _prolong(self, lev: _Level, e: torch.Tensor) -> torch.Tensor:
        if lev.kind == "packed":
            return _apply(lev.pt, e)
        # P e = (I − (ω/λ) d⁻¹ A) P0 e
        u = self._p0(lev, e)
        return u - (self.omega / lev.lmax) * (lev.dinv * _apply(lev.a, u))

    def _cycle(self, li: int, r: torch.Tensor) -> torch.Tensor:
        lev = self.levels[li]
        if li == len(self.levels) - 1:               # coarsest: exact solve
            return r @ self.coarse_inv
        x = self._smooth(lev, r)                     # pre-smooth (zero guess)
        rc = self._restrict(lev, r - _apply(lev.a, x))
        x = x + self._prolong(lev, self._cycle(li + 1, rc))
        return x + self._smooth(lev, r - _apply(lev.a, x))   # post-smooth

    def __call__(self, r) -> torch.Tensor:
        return self._cycle(0, torch.as_tensor(r, dtype=torch.float32,
                                              device=self.device))

    def solve(self, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
              maxiter: int | None = None):
        """AMG-preconditioned CG on the finest operator: ``(z, info)``."""
        from tpusparse_torch.solve import cg

        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        return cg(self.levels[0].apply_a, b, x0, tol=tol, atol=atol,
                  maxiter=maxiter, m_inv=self)

    def shard(self, mesh) -> "SmoothedAggregationAMG":
        """Multi-rank placement: a copy of the hierarchy whose grid and
        block levels apply their DIA operators through the halo partition
        over ``mesh``'s ``"n"`` dimension, where the level's n divides by D
        (the JAX package's rule; other levels run as they are). Dense
        levels, transfers, ``dinv`` and the coarse inverse are replicated.
        Levels placed already (greedy levels built with
        ``smoothed_aggregation(..., mesh=mesh)``, or an earlier ``shard``)
        pass through. A greedy hierarchy packed for one device is refused:
        its carriers are single-device packs."""
        from tpusparse_torch.formats.dia import DiaMatrix
        from tpusparse_torch.parallel.mesh import axis_size

        d = axis_size(mesh, "n")

        def place(lev: _Level) -> _Level:
            if any(isinstance(o, (_ShardedOp, _HaloDia))
                   for o in (lev.a, lev.p, lev.pt)):
                return lev                     # placed already
            ok_op = isinstance(lev.a, (torch.Tensor, DiaMatrix))
            ok_tr = lev.kind in ("grid", "block") or all(
                c is None or isinstance(c, torch.Tensor)
                for c in (lev.p, lev.pt))
            if not (ok_op and ok_tr):
                raise ValueError(
                    f"level n={lev.n} ({lev.fmt}|{lev.kind}) holds "
                    "single-device packed operators or carriers; build "
                    "greedy hierarchies sharded from the start with "
                    "smoothed_aggregation(..., mesh=mesh) (ragged-SELL "
                    "column shards), or use aggregation='grid'/'block' (or "
                    "raise dense_cutoff) for this placement")
            a = lev.a
            if isinstance(a, DiaMatrix) and lev.n % d == 0:
                a = _HaloDia(a, mesh)
            return _Level(a, lev.p, lev.pt, lev.dinv, lev.lmax, lev.n,
                          lev.nnz, lev.fmt, lev.kind, lev.shape2d)

        return SmoothedAggregationAMG(
            tuple(place(lv) for lv in self.levels), self.coarse_inv,
            self.theta, self.degree, self.ratio, self.omega, mesh=mesh)

    # -- persistence ---------------------------------------------------
    def save(self, path) -> None:
        """The whole hierarchy in one ``.npz``, in the JAX package's
        checkpoint layout: packed operators and carriers through
        ``formats.io.encode``, dense levels, weights and ``dinv`` as
        arrays, sizes and smoother constants in the manifest."""
        from tpusparse_torch.formats import io as _io

        if self.mesh is not None:
            raise ValueError(
                "sharded hierarchies (shard(mesh), smoothed_aggregation("
                "mesh=...)) are not saveable: persist the unsharded build "
                "and place it again after loading")
        arrays: dict[str, np.ndarray] = {}
        man_levels = []
        for i, lev in enumerate(self.levels):
            comps = {}
            for name in ("a", "p", "pt", "dinv"):
                obj = getattr(lev, name)
                if obj is None:
                    comps[name] = ("none",)
                elif isinstance(obj, torch.Tensor):
                    arrays[f"L{i}_{name}"] = obj.detach().cpu().numpy()
                    comps[name] = ("arr",)
                else:
                    kind, aux_r, dtypes_r, arrs = _io.encode(obj)
                    for j, a in enumerate(arrs):
                        arrays[f"L{i}_{name}_{j}"] = a
                    comps[name] = ("fmt", kind, aux_r, dtypes_r, len(arrs))
            man_levels.append(dict(
                n=int(lev.n), nnz=int(lev.nnz), fmt=lev.fmt, kind=lev.kind,
                shape2d=None if lev.shape2d is None
                else tuple(int(v) for v in lev.shape2d),
                lmax=None if lev.lmax is None else float(lev.lmax),
                comps=comps))
        manifest = dict(version=1,
                        params=(float(self.theta), int(self.degree),
                                float(self.ratio), float(self.omega)),
                        levels=man_levels)
        np.savez_compressed(path, manifest=np.asarray(repr(manifest)),
                            coarse_inv=self.coarse_inv.detach().cpu().numpy(),
                            **arrays)

    @classmethod
    def load(cls, path, device=None) -> "SmoothedAggregationAMG":
        """A hierarchy saved by :meth:`save` (or by the JAX package's), on
        ``device`` (None: the GPU)."""
        from tpusparse_torch.formats import io as _io

        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            if "manifest" not in z.files:
                raise ValueError(f"{path}: not a tpusparse AMG checkpoint")
            man = ast.literal_eval(str(z["manifest"]))
            if not isinstance(man, dict) or man.get("version") != 1:
                raise ValueError(f"{path}: unsupported AMG checkpoint "
                                 "version")
            levels = []
            for i, lm in enumerate(man["levels"]):
                vals = {}
                for name in ("a", "p", "pt", "dinv"):
                    tag = lm["comps"][name]
                    if tag[0] == "none":
                        vals[name] = None
                    elif tag[0] == "arr":
                        vals[name] = torch.from_numpy(
                            z[f"L{i}_{name}"]).to(dev)
                    else:
                        _, kind, aux_r, dtypes_r, n_arr = tag
                        arrs = [z[f"L{i}_{name}_{j}"] for j in range(n_arr)]
                        vals[name] = _io.decode(
                            kind, aux_r, dtypes_r, arrs,
                            where=f"{path}[L{i}.{name}]", device=dev)
                shape2d = lm["shape2d"]
                levels.append(_Level(
                    vals["a"], vals["p"], vals["pt"], vals["dinv"],
                    lm["lmax"], lm["n"], lm["nnz"], lm["fmt"], lm["kind"],
                    None if shape2d is None else tuple(shape2d)))
            coarse_inv = torch.from_numpy(z["coarse_inv"]).to(dev)
        th, dg, ra, om = man["params"]
        return cls(tuple(levels), coarse_inv, th, dg, ra, om)


def _pack(sp, dense_cutoff: int, square: bool, device: torch.device):
    """A host scipy matrix as ``v -> v @ sp`` on ``device``: a dense
    tensor below the cutoff, else the router's format for a square level
    operator, and for a tall or wide prolongator RSELL unsorted (the band
    of tiles is its locality; a column sort would scatter it) where the
    router's RSELL predicate admits it, else TCSR."""
    from tpusparse_torch.formats.auto import auto_format
    from tpusparse_torch.formats.rsell import RsellMatrix, rsell_pack_csr
    from tpusparse_torch.formats.tcsr import TcsrMatrix
    from tpusparse_torch.kernels.rsell_spmv import wide_fits

    m, n = sp.shape
    if max(m, n) <= dense_cutoff:
        return torch.from_numpy(sp.toarray().astype(np.float32)) \
            .to(device), "dense"
    csr = CsrMatrix.from_scipy(sp.astype(np.float32))
    if square:
        fmt = auto_format(csr, device=device)
    elif wide_fits(m, n):
        fmt = RsellMatrix._from_pack(rsell_pack_csr(csr, sort=False), device)
    else:
        fmt = TcsrMatrix.from_csr(csr, device=device)
    return fmt, type(fmt).__name__


def smoothed_aggregation(a, *, theta: float | str = "auto", degree: int = 2,
                         ratio: float = 8.0, coarse_size: int = 400,
                         max_levels: int = 12, omega: float = 4.0 / 3.0,
                         dense_cutoff: int = 2048,
                         aggregation: str = "auto", block_size: int = 8,
                         grid_block: int = 3, sym_tol: float = 1e-6,
                         device=None, mesh=None) -> SmoothedAggregationAMG:
    """Build a smoothed-aggregation AMG hierarchy for symmetric ``a`` (a
    ``CsrMatrix``, scipy sparse or dense array) on ``device`` (None: the
    GPU).

    ``theta``: strength drop tolerance; ``"auto"`` picks it per level from
    the coupling spectrum (0 for isotropic operators). ``degree``:
    Chebyshev smoother degree. ``ratio``: the smoother targets
    ``[lmax/ratio, 1.05 lmax]`` of ``D⁻¹A``. ``omega``: prolongator
    damping, ``P = (I - omega/lmax D⁻¹A) P0``. Levels at most
    ``dense_cutoff`` wide are dense; the hierarchy stops at
    ``coarse_size`` with a dense inverse. ``aggregation``: ``"greedy"``
    (Vanek aggregates, packed carriers), ``"grid"`` (``grid_block``-square
    blocks of a detected lattice, reshape transfers), ``"block"``
    (``block_size`` consecutive indices), or ``"auto"`` (block on narrow
    contiguous bands, greedy elsewhere), as in the JAX package.

    ``mesh``: build the hierarchy over a device mesh (call on every rank
    with the same ``a``): greedy levels above ``dense_cutoff`` become
    ragged-SELL column shards (``fmt`` ``"rsell-shard"``), the rest is
    placed by ``shard``. The device is then the mesh's."""
    _device(device, mesh)                # fail before the setup, not after
    host = host_hierarchy(
        a, theta=theta, coarse_size=coarse_size, max_levels=max_levels,
        omega=omega, aggregation=aggregation, block_size=block_size,
        grid_block=grid_block, sym_tol=sym_tol)
    return from_host(*host, degree=degree, ratio=ratio, omega=omega,
                     dense_cutoff=dense_cutoff, device=device, mesh=mesh)


def _device(device, mesh) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    from tpusparse_torch.parallel.mesh import mesh_device

    return mesh_device(mesh)


def from_host(levels_h, coarse, theta_resolved: float, *, degree: int = 2,
              ratio: float = 8.0, omega: float = 4.0 / 3.0,
              dense_cutoff: int = 2048, device=None,
              mesh=None) -> SmoothedAggregationAMG:
    """The device half of ``smoothed_aggregation``: pack a
    ``host_hierarchy`` (its three outputs) on ``device``, or over ``mesh``
    (see there)."""
    dev = _device(device, mesh)
    levels: list[_Level] = []
    for h in levels_h:
        n = h.sp.shape[0]
        shard_lvl = mesh is not None and h.kind == "packed" \
            and n > dense_cutoff
        if shard_lvl:
            a_op, fmt_name = _ShardedOp.from_scipy(h.sp, mesh), "rsell-shard"
        else:
            a_op, fmt_name = _pack(h.sp, dense_cutoff, square=True,
                                   device=dev)
        dinv = torch.from_numpy(h.dinv.astype(np.float32)).to(dev)
        lmax = float(np.float32(h.lmax))
        weights = (1.0 / np.sqrt(np.bincount(h.agg, minlength=h.n_agg)
                                 .astype(np.float64)[h.agg])) \
            .astype(np.float32)
        if h.kind == "grid":
            levels.append(_Level(a_op, torch.from_numpy(weights).to(dev),
                                 None, dinv, lmax, n, h.sp.nnz, fmt_name,
                                 kind="grid", shape2d=h.shape2d))
        elif h.kind == "block":
            w0 = np.zeros((h.n_agg, h.block_size), np.float32)
            w0.ravel()[:n] = weights
            levels.append(_Level(a_op, torch.from_numpy(w0).to(dev), None,
                                 dinv, lmax, n, h.sp.nnz, fmt_name,
                                 kind="block"))
        elif shard_lvl:
            # carriers shard over their output columns: P over the coarse
            # ids, Pt over the fine ids; vectors stay whole between levels
            levels.append(_Level(a_op, _ShardedOp.from_scipy(h.p, mesh),
                                 _ShardedOp.from_scipy(h.p.T.tocsr(), mesh),
                                 dinv, lmax, n, h.sp.nnz, fmt_name))
        else:
            p_op, _ = _pack(h.p, dense_cutoff, square=False, device=dev)
            pt_op, _ = _pack(h.p.T.tocsr(), dense_cutoff, square=False,
                             device=dev)
            levels.append(_Level(a_op, p_op, pt_op, dinv, lmax, n, h.sp.nnz,
                                 fmt_name))
    a_op, fmt_name = _pack(coarse, dense_cutoff, square=True, device=dev)
    levels.append(_Level(a_op, None, None, None, None, coarse.shape[0],
                         coarse.nnz, fmt_name))
    # coarse inverse, float64 on host then cast; applied as v @ inv(A)
    # (symmetric, so the row-vector convention needs no transpose)
    coarse_inv = torch.from_numpy(
        np.linalg.inv(coarse.toarray()).astype(np.float32)).to(dev)
    out = SmoothedAggregationAMG(tuple(levels), coarse_inv, theta_resolved,
                                 degree, ratio, omega)
    return out if mesh is None else out.shard(mesh)
