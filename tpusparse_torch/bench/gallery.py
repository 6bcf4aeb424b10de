"""Real-topology workload gallery and router regret, on the card.

Counterpart of ``tpusparse/bench/gallery.py``. It runs every competitive
format and the ``auto_format`` router on 13 generated workloads at their
published sizes (R-MAT graphs, Delaunay FEM meshes, 3D stencils,
anisotropic diffusion, a band with defects, N:M and block-pruned
weights) and records, per workload and batch:

- each candidate's device time (``bench.runner.device_time``: CUDA events
  after the read L2 flush, the median over ``trials``) and its share of
  the bytes bound (the format's bytes plus X read and Y written, at the
  card's published HBM rate);
- the format the router picks (``route_name``: ``formats.auto.route``,
  nothing packed), the fastest candidate and the routed one's regret.

Candidates keep the JAX package's gates: the dense baseline and ASP only
under the 320 MB dense cap (ASP also only above d = 0.15), flat SELL only
when the hub columns leave its padded bytes within 6x of the
nnz-proportional formats, DIA only at <= 512 diagonals. A pack over 1.8 GB
is recorded as ``skipped: "bytes"`` without being run, as in JAX, so the
rows stay comparable. The JAX names map to the port's registry names
(``NAMES``); ``dense_xla`` is cuBLAS through ``torch.matmul`` in true fp32
(``dense_torch``). Left out, as in JAX: ``ell_xla`` (the port's ``ell``, a
torch gather with no kernel) and ``bell_pallas`` (the port's BELL entry).

Each pack is made on the host (``pack_s``) and then uploaded
(``upload_s``, ``formats.io.to_device``). Every candidate's y is held to
the float64 oracle (scipy on the CSR, never a dense A) within 1e-3 before
it is timed. On the CPU (``device="cpu"``) the candidates run their plain
versions and are checked, and no time is recorded: ``device_time`` needs a
card. On the card a share above 1.05 fails the run (the JAX package's
``>2.0`` remeasure and ``slope_artifact`` stamp describe its TPU slope
method and have no counterpart).

Run: ``python -m tpusparse_torch.bench.gallery [--workloads a,b]
[--batch B] [--json PATH] [--cpu]``; no file is written unless ``--json``
names one.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from tpusparse_torch.bench.roofline import checked_share, format_bytes
from tpusparse_torch.bench.runner import device_time, run_id
from tpusparse_torch.bench.suite import _fmt_run, _full_plan_run
from tpusparse_torch.formats.io import to_device
from tpusparse_torch.testing import generators
from tpusparse_torch.testing.reference import csr_spmm_cpu
from tpusparse_torch.utils import resolve_device

_DENSE_CAP_BYTES = 320 << 20   # the JAX gallery's dense upload budget
_BYTES_CAP = 1.8e9             # a pack past this is recorded, not run
ATOL = 1e-3

# JAX candidate and route names -> the port's registry names
NAMES = {"dense_xla": "dense_torch", "sell": "sell_cuda",
         "binned": "sell_binned_cuda", "rsell": "rsell_cuda",
         "tcsr": "tcsr_cuda", "bsr": "bsr_cuda", "dia": "dia_cuda",
         "asp": "asp_cuda", "awsp": "awsp_cuda"}


def _w(builder: Callable[[], Any], note: str) -> dict[str, Any]:
    return dict(build=builder, note=note)


WORKLOADS: dict[str, dict[str, Any]] = {
    # graphs: hubs + locality (Graph500 R-MAT parameters)
    "rmat-s13-ef16": _w(lambda: generators.rmat_csr(13, 16, seed=1),
                        "8192^2 R-MAT graph, ~128k edges: hub columns drive "
                        "global SELL width, the skew-router case"),
    "rmat-s13-ef64": _w(lambda: generators.rmat_csr(13, 64, seed=2),
                        "denser 8192^2 R-MAT (~500k edges)"),
    "rmat-s12-sym": _w(lambda: generators.rmat_csr(12, 24, seed=3,
                                                   symmetric=True),
                       "4096^2 symmetrized R-MAT (undirected graph)"),
    # FEM / mesh
    "mesh2d-96": _w(lambda: generators.mesh_csr(96, 96, seed=4),
                    "9216-node Delaunay FEM graph Laplacian (deg 4-9)"),
    "mesh2d-256": _w(lambda: generators.mesh_csr(256, 256, seed=5),
                     "65536-node Delaunay FEM graph Laplacian"),
    # lattice stencils (the DIA cases)
    "stencil3d-7pt-48": _w(lambda: generators.stencil_csr((48, 48, 48)),
                           "110592-unknown 3D 7-point Poisson"),
    "stencil3d-27pt-32": _w(lambda: generators.stencil_csr((32, 32, 32),
                                                           points=27),
                            "32768-unknown 3D 27-point (wide-band DIA)"),
    "aniso2d-eps100": _w(lambda: generators.stencil_csr((512, 512),
                                                        eps=100.0,
                                                        eps_axis=1),
                         "262144-unknown anisotropic diffusion, eps=100"),
    "stencil2d-64": _w(lambda: generators.stencil_csr((64, 64)),
                       "4096-unknown 2D 5-point Poisson: the one stencil "
                       "small enough for a measured dense baseline"),
    # perturbed banded (must not route to pure DIA)
    "banded-defects-8192": _w(
        lambda: generators.banded_defects_csr(8192, bandwidth=32,
                                              defect_density=1e-3, seed=6),
        "8192^2, 65-diagonal band + 0.1% long-range defects: defects spray "
        "O(n) diagonals at negligible nnz"),
    # pruned-weight families (dense ndarrays)
    "nm-2of4-4096": _w(lambda: generators.nm_pruned_matrix(4096, 4096,
                                                           2, 4, seed=7),
                       "4096^2 2:4 semi-structured pruned weights (d=0.5)"),
    "nm-1of4-4096": _w(lambda: generators.nm_pruned_matrix(4096, 4096,
                                                           1, 4, seed=8),
                       "4096^2 1:4 pruned weights (d=0.25)"),
    "blockpruned-4096": _w(
        lambda: generators.block_pruned_matrix(4096, 4096, block=128,
                                               keep_frac=0.3, fill=0.5,
                                               seed=9),
        "4096^2 block-pruned: 30% of 128^2 tiles kept at 50% fill"),
}


def build(name: str):
    """The workload's ``CsrMatrix`` (dense builders are converted)."""
    from tpusparse_torch.formats.csr import CsrMatrix

    a = WORKLOADS[name]["build"]()
    return a if isinstance(a, CsrMatrix) else CsrMatrix.from_dense(a)


def candidates(csr, stats: dict[str, Any], *, batch: int = 1,
               dense_cap: int = _DENSE_CAP_BYTES) -> list[dict[str, Any]]:
    """The applicable entries for one workload: name, prepare(csr) -> a
    pack on the host, run(pack, x) -> y. The gates are the JAX
    package's."""
    from tpusparse_torch.formats.binned import BinnedSellMatrix
    from tpusparse_torch.formats.bsr import BsrMatrix
    from tpusparse_torch.formats.dia import DiaMatrix
    from tpusparse_torch.formats.rsell import RsellMatrix
    from tpusparse_torch.formats.sell import SellMatrix
    from tpusparse_torch.formats.tcsr import TcsrMatrix
    from tpusparse_torch.kernels.asp_spmv import AspMatrix
    from tpusparse_torch.kernels.dense import dense_torch
    from tpusparse_torch.utils import round_up

    m, n = csr.shape
    dense_bytes = m * n * 4
    out: list[dict[str, Any]] = []

    def add(jax_name, prepare, run=_fmt_run):
        out.append(dict(name=NAMES[jax_name], prepare=prepare, run=run))

    if dense_bytes <= dense_cap:
        add("dense_xla", lambda c: torch.from_numpy(
            np.ascontiguousarray(c.to_dense(), np.float32)),
            lambda f, x: dense_torch(f, x))
    # flat SELL pads every column to the global width; a hub column of
    # degree ~n makes that bytes-catastrophic, not just slow
    est_sell = (-(-n // 128)) * (-(-m // 128)) * \
        round_up(max(stats["w_global"], 8), 8) * 128 * 5
    if est_sell <= 6 * max(5 * stats["nnz"], 1 << 20):
        add("sell", lambda c: SellMatrix.from_csr(c, device="cpu"))
    add("binned", lambda c: BinnedSellMatrix.from_csr(c, device="cpu"))
    add("rsell", lambda c: RsellMatrix.from_csr(c, device="cpu"))
    add("tcsr", lambda c: TcsrMatrix.from_csr(c, expect_batch=batch,
                                              device="cpu"))
    add("bsr", lambda c: BsrMatrix.from_csr(c, device="cpu"))
    if 0 < stats["n_diags"] <= 512:
        add("dia", lambda c: DiaMatrix.from_csr(c, device="cpu"))
    if dense_bytes <= dense_cap and stats["density"] > 0.15:
        add("asp", lambda c: AspMatrix.from_csr(c, device="cpu"),
            _full_plan_run)
    return out


def route_name(csr, stats: dict[str, Any], batch: int = 1) -> str:
    """The port's name of what ``auto_format`` would pick, without
    packing it."""
    from tpusparse_torch.formats.auto import route

    m, n = csr.shape
    return NAMES[route(m, n, stats, expect_batch=batch)]


def gallery_x(m: int, batch: int, x_seed: int = 0) -> np.ndarray:
    """The JAX gallery's X: dense uniform(-1, 1) serving activations,
    (m,) at B = 1, else (batch, m)."""
    rng = np.random.default_rng(x_seed ^ 0xA11)
    x = rng.uniform(-1.0, 1.0, size=(batch, m)).astype(np.float32)
    return x[0] if batch == 1 else x


def _placed(fmt, dev: torch.device):
    if isinstance(fmt, torch.Tensor):
        return fmt.to(dev)
    return fmt if dev.type == "cpu" else to_device(fmt, dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_workload(name: str, *, batch: int = 1, device=None,
                 json_path: str | None = None, stamp: str | None = None,
                 verbose: bool = True, x_seed: int = 0,
                 trials: int = 1) -> dict[str, Any]:
    """Check every applicable candidate on one workload against the
    float64 oracle, time it on the card (the median of ``trials``
    ``device_time`` calls) and return the record (appended to
    ``json_path`` when one is given). Raises if a candidate is off the
    oracle by more than 1e-3 or reads above the physical bound."""
    from tpusparse_torch.formats.auto import matrix_stats_csr

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    a = build(name)
    stats = matrix_stats_csr(a)
    m, n = a.shape
    x = gallery_x(m, batch, x_seed)
    xt = torch.from_numpy(x).to(dev)
    want = csr_spmm_cpu(x, a)
    io_bytes = batch * (m + n) * 4          # X read + Y written per call
    routed = route_name(a, stats, batch)
    rows: dict[str, dict[str, Any]] = {}
    for e in candidates(a, stats, batch=batch):
        t0 = time.perf_counter()
        fmt = e["prepare"](a)
        pack_s = time.perf_counter() - t0
        nbytes = format_bytes(fmt)
        if nbytes > _BYTES_CAP:
            rows[e["name"]] = dict(us=None, mb=nbytes / 1e6, roofline=None,
                                   pack_s=pack_s, skipped="bytes")
            if verbose:
                print(f"  {name}/{e['name']}: skipped ({nbytes / 1e9:.1f} "
                      f"GB pack)", file=sys.stderr)
            del fmt
            continue
        t0 = time.perf_counter()
        fmt = _placed(fmt, dev)
        _sync(dev)
        upload_s = time.perf_counter() - t0
        y = e["run"](fmt, xt)
        err = float(np.abs(y.double().cpu().numpy() - want).max())
        if not err <= ATOL:
            raise AssertionError(f"{name}/{e['name']} B={batch}: max|err| "
                                 f"{err:.3e} > {ATOL} against the oracle")
        row = dict(us=None, mb=nbytes / 1e6, io_mb=io_bytes / 1e6,
                   roofline=None, pack_s=pack_s, upload_s=upload_s,
                   max_abs_err=err)
        if on_card:
            step_bytes = nbytes + io_bytes
            secs = []
            for _ in range(max(1, trials)):
                r = device_time(e["run"], fmt, xt,
                                name=f"{name}/{e['name']}",
                                bytes_moved=step_bytes, nnz=a.nnz)
                secs.append(r.seconds)
                if verbose:
                    print(f"  {r} | pack {pack_s:.2f} s", file=sys.stderr)
            med = float(np.median(secs))
            share = checked_share(step_bytes, med,
                                  f"{name}/{e['name']} B={batch}")
            row.update(us=med * 1e6, roofline=share)
            if len(secs) > 1:
                row.update(trials=len(secs), us_min=min(secs) * 1e6,
                           us_max=max(secs) * 1e6,
                           spread_pct=100 * (max(secs) - min(secs)) / med)
        rows[e["name"]] = row
        del fmt
    timed = {k: v for k, v in rows.items() if v["us"] is not None}
    best = min(timed, key=lambda k: timed[k]["us"]) if timed else None
    regret = None
    if best is not None and routed in timed:
        regret = 100 * (timed[routed]["us"] / timed[best]["us"] - 1.0)
    rec = dict(run=stamp or run_id(dev), workload=name, batch=batch,
               m=m, n=n, nnz=a.nnz, density=stats["density"],
               note=WORKLOADS[name]["note"], routed=routed, best=best,
               regret_pct=regret, rows=rows,
               device=torch.cuda.get_device_name(dev) if on_card else "cpu")
    if json_path:
        _append(json_path, rec)
    if verbose:
        print(f"{name} B={batch}: routed={routed} best={best} "
              f"regret={regret}", file=sys.stderr)
    return rec


def _append(path: str, rec: dict[str, Any]) -> None:
    recs = [r for r in load(path)
            if (r["workload"], r["batch"]) != (rec["workload"], rec["batch"])]
    recs.append(rec)
    with open(path, "w") as f:
        json.dump(recs, f, indent=1)


def load(path: str) -> list[dict[str, Any]]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def render(recs: list[dict[str, Any]], out=sys.stdout) -> None:
    """A Markdown table of the records: the route, the best candidate, the
    regret, and the routed, best and dense times."""
    if not recs:
        print("(no gallery records)", file=out)
        return
    print(f"(runs: {', '.join(sorted({r['run'] for r in recs}))})\n",
          file=out)
    print("| workload | nnz | d | routed | best | regret % | routed us | "
          "best us | dense us |\n|---|---|---|---|---|---|---|---|---|",
          file=out)
    for r in sorted(recs, key=lambda r: (r["workload"], r["batch"])):
        rows = r["rows"]

        def us(k):
            v = rows.get(k, {}).get("us") if k else None
            return "-" if v is None else f"{v:.2f}"

        wl = r["workload"] + (f" (B={r['batch']})" if r["batch"] != 1 else "")
        regret = "-" if r["regret_pct"] is None else f"{r['regret_pct']:.1f}"
        print(f"| {wl} | {r['nnz']:,} | {r['density']:.2g} | {r['routed']} "
              f"| {r['best']} | {regret} | {us(r['routed'])} | "
              f"{us(r['best'])} | {us(NAMES['dense_xla'])} |", file=out)
    timed = [r for r in recs if r["regret_pct"] is not None]
    bad = [r for r in timed if r["regret_pct"] > 10.0]
    print(f"\nRouter regret <= 10% on {len(timed) - len(bad)}/{len(timed)} "
          f"timed workloads." + (" Misroutes: " + ", ".join(
              f"{r['workload']} B={r['batch']} ({r['routed']} vs "
              f"{r['best']}, +{r['regret_pct']:.1f}%)" for r in bad)
              if bad else ""), file=out)


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="tpusparse_torch gallery",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workloads", default="all",
                   help="comma list or 'all' (see --list)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--trials", type=int, default=1,
                   help="device_time calls per candidate; the recorded us "
                        "is their median")
    p.add_argument("--json", default=None,
                   help="append the records to this file (none by default)")
    p.add_argument("--list", action="store_true")
    p.add_argument("--render", action="store_true",
                   help="print the table of --json's records and exit")
    p.add_argument("--cpu", action="store_true",
                   help="check on the CPU (plain versions, no times)")
    args = p.parse_args(argv)
    if args.list:
        for k, v in WORKLOADS.items():
            print(f"{k:24s} {v['note']}")
        return 0
    if args.render:
        render(load(args.json) if args.json else [])
        return 0
    names = list(WORKLOADS) if args.workloads == "all" \
        else args.workloads.split(",")
    dev = "cpu" if args.cpu else None
    stamp = run_id(dev)
    recs = [run_workload(name, batch=args.batch, device=dev,
                         json_path=args.json, stamp=stamp,
                         trials=args.trials) for name in names]
    render(recs)
    print(json.dumps({"gallery": recs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
