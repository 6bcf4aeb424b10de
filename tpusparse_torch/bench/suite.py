"""Headline benchmark suite (counterpart of ``tpusparse/bench/suite.py``).

The headline registry is the reference's one workload, ``Y = X @ A`` in
fp32 at M = N = 4096 with ~50% sparsity in A and X, through four entries:
``dense_torch`` (cuBLAS, the vendor baseline), ``dense_cuda`` (K2),
``sell_cuda`` (K1) and ``awsp_cuda`` (K3, g = 8, full plan). The full
registry adds the JAX package's full list in its order
(``tpusparse/bench/suite.py``), renamed: ``ell_torch`` (a torch gather, no
kernel), ``bell_cuda`` (K12), ``sell_binned_cuda`` (K1 per bucket, then
K5), ``bsr_cuda`` (K6, block_m = 512), ``tcsr_cuda`` (K7 and/or K6),
``rsell_cuda`` (K4, and K5 for a sorted pack) and ``asp_cuda`` (K9, full
plan).
"""

from __future__ import annotations

from typing import Any

import torch

from tpusparse_torch.bench.roofline import (card_info, checked_share,
                                            detect_hbm_gbps, format_bytes,
                                            roofline_fraction)
from tpusparse_torch.bench.runner import BenchResult, device_time
from tpusparse_torch.config import SpmvConfig
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import resolve_device


def _canonical_workload(cfg: SpmvConfig):
    a = generators.random_sparse_matrix(cfg.m, cfg.n, density=cfg.density,
                                        seed=cfg.seed,
                                        distribution=cfg.distribution)
    if cfg.batch == 1:
        x = generators.random_sparse_vector(cfg.m, density=cfg.x_density,
                                            seed=cfg.seed)
    else:
        x = generators.random_sparse_batch(cfg.batch, cfg.m,
                                           density=cfg.x_density,
                                           seed=cfg.seed)
    return a, x


def _fmt_run(f, x):
    return f.spmv(x) if x.ndim == 1 else f.spmm(x)


def _full_plan_run(f, x):
    # the i.i.d. benchmark visits every group: pass the full plan (a cached
    # device tensor) so no host plan is built inside the timed call
    plan = f._full_plan()
    return f.spmv(x, plan=plan) if x.ndim == 1 else f.spmm(x, plan=plan)


def _dense_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def registry(full: bool = False) -> list[dict[str, Any]]:
    """The headline entries (``full``: and the other ported formats):
    name, prepare(dense, device) -> fmt, run(fmt, x) -> y."""
    from tpusparse_torch.formats.awsp import AwspMatrix
    from tpusparse_torch.formats.bell import BellMatrix
    from tpusparse_torch.formats.binned import BinnedSellMatrix
    from tpusparse_torch.formats.bsr import BsrMatrix
    from tpusparse_torch.formats.ell import EllMatrix
    from tpusparse_torch.formats.rsell import RsellMatrix
    from tpusparse_torch.formats.sell import SellMatrix
    from tpusparse_torch.formats.tcsr import TcsrMatrix
    from tpusparse_torch.kernels.asp_spmv import AspMatrix
    from tpusparse_torch.kernels.dense import dense_cuda, dense_torch

    entries = [
        dict(name="dense_torch", prepare=_dense_tensor,
             run=lambda f, x: dense_torch(f, x)),
        dict(name="dense_cuda", prepare=_dense_tensor,
             run=lambda f, x: dense_cuda(f, x)),
        dict(name="sell_cuda",
             prepare=lambda a, d: SellMatrix.from_dense(a, device=d),
             run=_fmt_run),
        # g=8 as in the JAX headline: the canonical X is i.i.d. and fully
        # live, so every group is visited
        dict(name="awsp_cuda",
             prepare=lambda a, d: AwspMatrix.from_dense(a, g=8, device=d),
             run=_full_plan_run),
    ]
    if full:
        entries += [
            dict(name="ell_torch",
                 prepare=lambda a, d: EllMatrix.from_dense(a, device=d),
                 run=_fmt_run),
            dict(name="bell_cuda",
                 prepare=lambda a, d: BellMatrix.from_dense(a, device=d),
                 run=_fmt_run),
            dict(name="sell_binned_cuda",
                 prepare=lambda a, d: BinnedSellMatrix.from_dense(a, device=d),
                 run=_fmt_run),
            dict(name="bsr_cuda",
                 prepare=lambda a, d: BsrMatrix.from_dense(a, block_m=512,
                                                           device=d),
                 run=_fmt_run),
            dict(name="tcsr_cuda",
                 prepare=lambda a, d: TcsrMatrix.from_dense(a, device=d),
                 run=_fmt_run),
            dict(name="rsell_cuda",
                 prepare=lambda a, d: RsellMatrix.from_dense(a, device=d),
                 run=_fmt_run),
            dict(name="asp_cuda",
                 prepare=lambda a, d: AspMatrix.from_dense(a, device=d),
                 run=_full_plan_run),
        ]
    return entries


def sweep(cfg: SpmvConfig | None = None, verbose: bool = True,
          full: bool = False,
          entries: list[dict[str, Any]] | None = None) -> list[BenchResult]:
    """Time ``entries`` (default: the registry, ``full`` or headline) on
    the configured workload (GPU only)."""
    cfg = cfg or SpmvConfig()
    dev = resolve_device(None)
    a, x = _canonical_workload(cfg)
    x_dev = torch.as_tensor(x, device=dev)
    nnz = int((a != 0).sum())
    results = []
    for e in entries if entries is not None else registry(full=full):
        fmt = e["prepare"](a, dev)
        nbytes = format_bytes(fmt)
        r = device_time(e["run"], fmt, x_dev, name=e["name"],
                        bytes_moved=nbytes, flops=2 * nnz * cfg.batch,
                        nnz=nnz)
        results.append(r)
        if verbose:
            frac = roofline_fraction(nbytes, r.seconds)
            print(f"{r} | {frac*100:.0f}% of HBM roofline on its own bytes")
    return results


def headline() -> dict[str, Any]:
    """One JSON-able dict: best kernel vs the cuBLAS baseline, with the
    card's name and power limit."""
    cfg = SpmvConfig()
    results = sweep(cfg, verbose=False)
    dense = next(r for r in results if r.name == "dense_torch")
    best = min(results, key=lambda r: r.seconds)
    card = card_info()
    hbm = detect_hbm_gbps()

    def row(r: BenchResult) -> dict[str, Any]:
        share = checked_share(r.bytes_moved, r.seconds, r.name, hbm)
        return {"us": round(r.seconds * 1e6, 1),
                "gbps": round(r.gbps, 1) if r.gbps else None,
                "roofline_frac": round(share, 3)}

    return {
        "metric": f"spmv_nnz_per_s[{best.name}] M=N=4096 d=0.5 fp32",
        "value": round(best.nnz_per_s / 1e9, 3),
        "unit": "Gnnz/s",
        "vs_baseline": round(dense.seconds / best.seconds, 3),
        "detail": {r.name: row(r) for r in results},
        "hbm_gbps_assumed": hbm,
        "device_kind": torch.cuda.get_device_name(0),
        "power_limit_w": card["power_limit_w"],
    }
