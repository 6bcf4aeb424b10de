"""``python -m tpusparse_torch.bench.report``: the measured report, in
Markdown, one section per workload family.

Counterpart of ``tpusparse/bench/report.py``: each section builds the JAX
section's workloads (shapes, densities, seeds, batches) and times them
with ``bench.runner.device_time`` (CUDA events after a read L2 flush) on
the card, whose name and power limit head the report. The sections
(``SECTIONS``, in the JAX order of ``main``):

- ``canonical``: the reference workload (4096^2, d(A) = d(X) = 0.5)
  through the full registry but ``ell_torch`` (a torch gather, no kernel;
  JAX leaves out ``ell_xla`` the same way);
- ``powerlaw`` (d = 0.25, binned SELL's case), ``lowdensity`` (d = 0.1),
  ``spmm`` (B = 8): named registry entries on their matrices;
- ``structured``: X live in its first quarter, AWSP with its host plan;
- ``tcsr``: 35% of 128^2 tiles at 40% fill: SELL, BSR, TCSR, RSELL;
- ``floors``: the SpMM strategy floors (below);
- ``reduced``: SELL with fp32, bf16 and int8 value storage;
- ``crossover``: SELL against dense over d(A) in 0.05 .. 0.9;
- ``training``: ``trainable_linear``'s forward and fwd+bwd step;
- ``solver``: a CG iteration on the 1M-unknown Laplacian (DIA, K8),
  from the slope between two fixed iteration counts.

Every timed row also gives its share of the bytes bound (the format's
bytes at the card's published HBM rate); a share above 1.05 fails the run.
``main`` first runs ``verify_docs`` on the port's own records.

The floors study: on the JAX package's grid, M = N = 4096, A uniform at d
in {0.1, 0.5} (seed 0), X ~50% nonzero (seed 0), B in {1, 8, 32}, it
times four ways to compute ``Y = X @ A``:

- ``gather``: K1, the SELL gather kernel (``kernels/sell_spmv.py``);
- ``decompress``: K11, each SELL tile decompressed into a dense 128 x 128
  tile and multiplied over the batch on the tensor cores in 3xTF32
  (``kernels/sell_mxu_spmm.py``);
- ``dense``: cuBLAS in true fp32 (``dense_torch``, TF32 off);
- ``cusparse``: cuSPARSE CSR of A.T times X (the library call for the same
  function), timed here only.

``check_points`` holds K11 against its plain version (atol 1e-4) and the
float64 oracle (atol 1e-3) at every point; ``floors`` (after those checks,
unless told they were made) times the four and prints a Markdown table
beside each point's bounds: the function's (the SELL pack's bytes at
3.35 TB/s against 2*nnz*B flops at the fp32 peak) and K11's own (its
dense 2*M*N*B flops at that peak). Needs a CUDA card: ``device_time``
raises without one.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np
import torch

from tpusparse_torch.bench.roofline import (ARTIFACT_SHARE, card_info,
                                            checked_share, detect_hbm_gbps,
                                            format_bytes)
from tpusparse_torch.bench.runner import BenchResult, device_time, run_id
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.kernels.dense import dense_torch
from tpusparse_torch.kernels.sell_mxu_spmm import (sell_mxu_spmm,
                                                   sell_mxu_spmm_plain)
from tpusparse_torch.kernels.sell_spmv import sell_spmm
from tpusparse_torch.testing import generators, reference
from tpusparse_torch.utils import resolve_device

SIZE = 4096
DENSITIES = (0.1, 0.5)
BATCHES = (1, 8, 32)
FP32_TFLOPS = 67.0        # H100 SXM fp32 peak outside the tensor cores
TF32_TFLOPS = 495.0       # H100 SXM dense TF32 peak of the tensor cores
ATOL, PLAIN_ATOL = 1e-3, 1e-4


def workloads(dev) -> list[dict[str, Any]]:
    """The grid's matrices: dense A, its SELL pack and the CSR of A.T on
    ``dev``, one per density."""
    out = []
    for d in DENSITIES:
        a = generators.random_sparse_matrix(SIZE, SIZE, density=d, seed=0)
        out.append(dict(
            density=d, a=a, a_dev=torch.from_numpy(a).to(dev),
            sell=SellMatrix.from_dense(a, device=dev),
            at_csr=torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)
            .to_sparse_csr()))
    return out


def check_mxu(sell: SellMatrix, x: np.ndarray, a: np.ndarray) -> tuple:
    """K11 against its plain version and the float64 oracle; raises on a
    mismatch. Returns (|kernel - plain|, |kernel - oracle|)."""
    xt = torch.from_numpy(x).to(sell.device)
    n = sell.shape[1]
    yk = sell_mxu_spmm(sell.idx, sell.vals, xt, n=n)
    yp = sell_mxu_spmm_plain(sell.idx, sell.vals, xt, n=n)
    want = torch.from_numpy(reference.sgemm_cpu(x, a)).to(sell.device)
    e_plain = float((yk.double() - yp.double()).abs().max())
    e_ref = float((yk.double() - want.double()).abs().max())
    if not (e_plain <= PLAIN_ATOL and e_ref <= ATOL):
        raise AssertionError(f"K11 {sell.shape} B={x.shape[0]}: |k-plain| "
                             f"{e_plain:.3e}, |k-oracle| {e_ref:.3e}")
    return e_plain, e_ref


def grid_batch(b: int) -> np.ndarray:
    return generators.random_sparse_batch(b, SIZE, density=0.5, seed=0)


def check_points(loads: list[dict[str, Any]]) -> dict[tuple, tuple]:
    """K11 at every (d, B) point against its plain version and the oracle:
    {(d, B): (|kernel - plain|, |kernel - oracle|)}; raises on a mismatch."""
    return {(wl["density"], b): check_mxu(wl["sell"], grid_batch(b), wl["a"])
            for wl in loads for b in BATCHES}


def floors(out=sys.stdout, loads: list[dict[str, Any]] | None = None,
           device=None, check: bool = True) -> list[dict[str, Any]]:
    """Time the grid (after ``check_points`` unless ``check`` is False);
    print the Markdown table to ``out`` and return one dict per (d, B)
    point (times in ms)."""
    dev = resolve_device(device)
    loads = loads if loads is not None else workloads(dev)
    if check:
        check_points(loads)
    hbm = detect_hbm_gbps() * 1e9
    rows = []
    for wl in loads:
        s, a = wl["sell"], wl["a"]
        nnz = int((a != 0).sum())
        for b in BATCHES:
            xt = torch.from_numpy(grid_batch(b)).to(dev)
            at_csr = wl["at_csr"]
            times = {
                "gather_ms": device_time(
                    lambda: sell_spmm(s.idx, s.vals, xt, n=SIZE)).seconds,
                "mxu_ms": device_time(
                    lambda: sell_mxu_spmm(s.idx, s.vals, xt, n=SIZE)).seconds,
                "dense_ms": device_time(
                    lambda: dense_torch(wl["a_dev"], xt)).seconds,
                "cusparse_ms": device_time(lambda: at_csr @ xt.T).seconds,
            }
            nbytes = format_bytes(s) + 4 * 2 * b * SIZE       # + x and y
            t_bytes = nbytes / hbm
            t_ops = 2 * nnz * b / (FP32_TFLOPS * 1e12)
            rows.append(dict(
                density=wl["density"], w=s.w, batch=b, nnz=nnz,
                bytes=nbytes,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                mxu_tc_floor_ms=3 * 2 * SIZE * SIZE * b
                / (TF32_TFLOPS * 1e12) * 1e3,
                **{k: v * 1e3 for k, v in times.items()}))
    _table(rows, out)
    return rows


def _table(rows: list[dict[str, Any]], out) -> None:
    card = card_info()
    print(f"## SpMM strategy floors on {card['line']} (M = N = {SIZE}, fp32,"
          f" us per call)\n", file=out)
    print("| d | W | B | K1 gather | K11 decompress | cuBLAS dense | "
          "cuSPARSE CSR | bound (function) | K11 tensor-core floor "
          "(3xTF32) |\n"
          "|---|---|---|---|---|---|---|---|---|", file=out)
    for r in rows:
        print(f"| {r['density']} | {r['w']} | {r['batch']} | "
              f"{r['gather_ms'] * 1e3:.2f} | {r['mxu_ms'] * 1e3:.2f} | "
              f"{r['dense_ms'] * 1e3:.2f} | {r['cusparse_ms'] * 1e3:.2f} | "
              f"{r['bound_ms'] * 1e3:.2f} ({r['bound_by']}) | "
              f"{r['mxu_tc_floor_ms'] * 1e3:.2f} |", file=out)
    print(file=out)


# the JAX registry's names -> the port's (``bench/suite.py``)
REGISTRY_NAMES = {"dense_xla": "dense_torch", "dense_pallas": "dense_cuda",
                  "sell_pallas": "sell_cuda", "awsp_pallas": "awsp_cuda",
                  "ell_xla": "ell_torch", "bell_pallas": "bell_cuda",
                  "sell_binned_pallas": "sell_binned_cuda",
                  "bsr_pallas": "bsr_cuda", "tcsr_pallas": "tcsr_cuda",
                  "rsell_pallas": "rsell_cuda", "asp_pallas": "asp_cuda"}
SECTIONS = ("canonical", "powerlaw", "lowdensity", "structured", "spmm",
            "tcsr", "floors", "reduced", "crossover", "training", "solver")
CROSSOVER = (0.05, 0.1, 0.2, 0.35, 0.5, 0.7, 0.9)
SOLVER_SIDE = 1024
SOLVER_ITERS = (16, 272)      # the JAX section's k1, k2


def laplacian_2d(side: int):
    """The SPD 5-point Laplacian (4 on the diagonal) on a side x side grid,
    built as COO, never densified (the JAX solver section's operator)."""
    from tpusparse_torch.formats.csr import CsrMatrix

    n = side * side
    idx = np.arange(n).reshape(side, side)
    rows, cols = [np.arange(n)], [np.arange(n)]
    vals = [np.full(n, 4.0, np.float32)]
    for (di, dj) in ((0, 1), (1, 0)):
        src = idx[: side - di, : side - dj].ravel()
        dst = idx[di:, dj:].ravel()
        for (r, c) in ((src, dst), (dst, src)):
            rows.append(r)
            cols.append(c)
            vals.append(np.full(r.size, -1.0, np.float32))
    return CsrMatrix.from_coo(n, n, np.concatenate(rows),
                              np.concatenate(cols), np.concatenate(vals))


def _tcsr_matrix() -> np.ndarray:
    rng = np.random.default_rng(3)
    m = n = SIZE
    keep = rng.random((m // 128, n // 128)) < 0.35
    keep.flat[0] = True
    mask = np.kron(keep, np.ones((128, 128), bool)) & \
        (rng.random((m, n)) < 0.4)
    a = (rng.uniform(-1, 1, (m, n)) * mask).astype(np.float32)
    return np.where(mask & (a == 0), 1e-3, a).astype(np.float32)


def section_inputs(name: str) -> dict[str, Any]:
    """The JAX section's workloads: its A (or a function of d giving it),
    X, and the entries or formats it times."""
    rsm, rsv = generators.random_sparse_matrix, generators.random_sparse_vector
    full = [REGISTRY_NAMES[k] for k in REGISTRY_NAMES]
    if name == "canonical":
        from tpusparse_torch.config import SpmvConfig

        cfg = SpmvConfig()
        return dict(a=rsm(cfg.m, cfg.n, density=cfg.density, seed=cfg.seed),
                    x=rsv(cfg.m, density=cfg.x_density, seed=cfg.seed),
                    entries=[e for e in full if e != "ell_torch"])
    if name == "powerlaw":
        return dict(a=rsm(SIZE, SIZE, density=0.25, seed=1,
                          distribution="powerlaw"),
                    x=rsv(SIZE, density=0.5, seed=1),
                    entries=["dense_torch", "sell_cuda", "sell_binned_cuda",
                             "rsell_cuda"])
    if name == "lowdensity":
        return dict(a=rsm(SIZE, SIZE, density=0.1, seed=2),
                    x=rsv(SIZE, density=0.5, seed=2),
                    entries=["dense_torch", "sell_cuda", "awsp_cuda"])
    if name == "spmm":
        return dict(a=rsm(SIZE, SIZE, density=0.5, seed=4),
                    x=generators.random_sparse_batch(8, SIZE, density=0.5,
                                                     seed=4),
                    entries=["dense_torch", "sell_cuda", "awsp_cuda",
                             "bsr_cuda"])
    if name == "structured":
        x = rsv(SIZE, density=0.5, seed=3).copy()
        x[1024:] = 0
        return dict(a=rsm(SIZE, SIZE, density=0.5, seed=3), x=x,
                    entries=["dense_torch", "sell_cuda", "awsp_cuda"])
    if name == "tcsr":
        return dict(a=_tcsr_matrix(), x=rsv(SIZE, density=0.5, seed=3),
                    entries=["dense_torch", "sell_cuda", "bsr_cuda",
                             "tcsr_cuda", "rsell_cuda"])
    if name == "reduced":
        return dict(a=rsm(SIZE, SIZE, density=0.5, seed=0),
                    x=rsv(SIZE, density=0.5, seed=0),
                    dtypes=(None, "bfloat16", "int8"))
    if name == "crossover":
        return dict(a_of=lambda d: rsm(SIZE, SIZE, density=d, seed=0),
                    x=rsv(SIZE, density=0.5, seed=0), densities=CROSSOVER)
    if name == "floors":
        return dict(a_of=lambda d: rsm(SIZE, SIZE, density=d, seed=0),
                    x_of=grid_batch, densities=DENSITIES, batches=BATCHES)
    if name == "training":
        return dict(a=rsm(SIZE, SIZE, density=0.5, seed=0),
                    x=rsv(SIZE, density=0.5, seed=1))
    if name == "solver":
        return dict(csr=laplacian_2d(SOLVER_SIDE),
                    b=np.random.default_rng(0).normal(
                        size=SOLVER_SIDE ** 2).astype(np.float32))
    raise ValueError(f"unknown section {name!r}: one of {SECTIONS}")


_HDR = ("| kernel | us | GB/s (own bytes) | share of the bytes bound | "
        "Gnnz/s |\n|---|---|---|---|---|")


def _row(label: str, r: BenchResult) -> str:
    share = checked_share(r.bytes_moved, r.seconds, label)
    return (f"| {label} | {r.seconds * 1e6:.2f} | {r.gbps:.0f} | "
            f"{share:.3f} | {r.nnz_per_s / 1e9:.2f} |")


def _rows(results: list[BenchResult], out, base: str = "dense_torch") -> None:
    """The table of ``results``, each beside the dense baseline's time."""
    t0 = next((r.seconds for r in results if r.name == base), None)
    print(_HDR, file=out)
    for r in results:
        vs = f" ({t0 / r.seconds:.2f}x dense)" \
            if t0 is not None and r.name != base else ""
        print(_row(r.name + vs, r), file=out)
    print(file=out)


def _timed_entries(a, x, names, dev) -> list[BenchResult]:
    """The named registry entries on (a, x): their format's bytes, nnz(A)
    once a call."""
    from tpusparse_torch.bench.suite import registry

    by_name = {e["name"]: e for e in registry(full=True)}
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    nnz = int((a != 0).sum())
    out = []
    for name in names:
        e = by_name[name]
        fmt = e["prepare"](a, dev)
        out.append(device_time(e["run"], fmt, xt, name=name,
                               bytes_moved=format_bytes(fmt),
                               flops=2 * nnz * (x.shape[0] if x.ndim == 2
                                                else 1), nnz=nnz))
        print(f"  .. {out[-1]}", file=sys.stderr)
        del fmt
    return out


def _entries_section(name: str, title: str, out, dev, note: str = "") -> None:
    print(f"## {title}\n", file=out)
    print(name, file=sys.stderr)
    w = section_inputs(name)
    _rows(_timed_entries(w["a"], w["x"], w["entries"], dev), out)
    if note:
        print(note + "\n", file=out)


def _canonical(out, dev) -> None:
    _entries_section("canonical", "Canonical workload (the reference's): "
                     "M = N = 4096, uniform, d(A) = d(X) = 0.5, fp32 SpMV",
                     out, dev, "(`ell_torch` is a torch gather with no "
                     "kernel, left out as JAX leaves out `ell_xla`.)")


def _powerlaw(out, dev) -> None:
    _entries_section("powerlaw", "Power-law columns: M = N = 4096, powerlaw, "
                     "d(A) = 0.25 (binned SELL's case)", out, dev)


def _lowdensity(out, dev) -> None:
    _entries_section("lowdensity", "Low density: M = N = 4096, uniform, "
                     "d(A) = 0.1", out, dev)


def _spmm(out, dev) -> None:
    _entries_section("spmm", "SpMM: B = 8, M = N = 4096, uniform d = 0.5",
                     out, dev, "(per call; Gnnz/s counts nnz(A) once a "
                     "call: times B = 8 for the elements multiplied.)")


def _structured(out, dev) -> None:
    from tpusparse_torch.formats.awsp import AwspMatrix

    print("## Structured activations: d(A) = 0.5 uniform, X live only in "
          "its first 1/4 of rows (g = 1 window groups, the host plan)\n",
          file=out)
    print("structured X", file=sys.stderr)
    w = section_inputs("structured")
    a, x = w["a"], w["x"]
    rows = _timed_entries(a, x, ["dense_torch", "sell_cuda"], dev)
    f = AwspMatrix.from_dense(a, device=dev)
    plan = torch.as_tensor(f.plan(x), dtype=torch.int32, device=dev)
    xt = torch.from_numpy(x).to(dev)
    rows.append(device_time(lambda: f.spmv(xt, plan=plan),
                            name="awsp_cuda (planned)",
                            bytes_moved=f.device_bytes(x),
                            nnz=int((a != 0).sum())))
    _rows(rows, out)
    print("AWSP streams only the live window groups (its bytes are that "
          "subset); Gnnz/s counts all of A's nonzeros.\n", file=out)


def _tcsr(out, dev) -> None:
    from tpusparse_torch.formats.bsr import BsrMatrix
    from tpusparse_torch.formats.rsell import RsellMatrix
    from tpusparse_torch.formats.sell import SellMatrix
    from tpusparse_torch.formats.tcsr import TcsrMatrix

    print("## TCSR: 35% of 128 x 128 tiles kept, 40% in-tile fill, "
          "M = N = 4096 fp32 SpMV\n", file=out)
    print("tcsr", file=sys.stderr)
    w = section_inputs("tcsr")
    a, x = w["a"], w["x"]
    nnz = int((a != 0).sum())
    xt = torch.from_numpy(x).to(dev)
    rows = _timed_entries(a, x, ["dense_torch"], dev)
    for name, fmt in (("sell_cuda", SellMatrix.from_dense(a, device=dev)),
                      ("bsr_cuda (dense tiles)",
                       BsrMatrix.from_dense(a, device=dev)),
                      ("tcsr_cuda", TcsrMatrix.from_dense(a, device=dev)),
                      ("rsell_cuda", RsellMatrix.from_dense(a, device=dev))):
        rows.append(device_time(lambda f=fmt: f.spmv(xt), name=name,
                                bytes_moved=format_bytes(fmt), nnz=nnz))
        print(f"  .. {rows[-1]}", file=sys.stderr)
    _rows(rows, out)


def _reduced(out, dev) -> None:
    from tpusparse_torch.formats.sell import SellMatrix

    print("## Reduced precision: SELL with bf16 and int8 value storage "
          "(M = N = 4096, uniform d = 0.5)\n", file=out)
    print("reduced precision", file=sys.stderr)
    w = section_inputs("reduced")
    a, x = w["a"], w["x"]
    nnz = int((a != 0).sum())
    want = x.astype(np.float64) @ a.astype(np.float64)
    xt = torch.from_numpy(x).to(dev)
    print("| kernel | us | GB/s (own bytes) | share of the bytes bound | "
          "Gnnz/s | max abs err |\n|---|---|---|---|---|---|", file=out)
    base = None
    for dt in w["dtypes"]:
        s = SellMatrix.from_dense(a, dtype=dt, device=dev)
        err = float(np.abs(s.spmv(xt).double().cpu().numpy() - want).max())
        r = device_time(lambda f=s: f.spmv(xt),
                        name=f"sell[{str(s.vals.dtype).removeprefix('torch.')}]",
                        bytes_moved=format_bytes(s), nnz=nnz)
        base = base or r.seconds
        vs = "" if dt is None else f" ({base / r.seconds:.2f}x fp32)"
        print(_row(r.name + vs, r) + f" {err:.1e} |", file=out)
    print("\nbf16 and int8 store the values only (fp32 sums; int8 with "
          "per-column scales): serving lanes outside the 1e-3 fp32 "
          "contract, opt in through `SellMatrix.from_dense(a, dtype=...)`."
          "\n", file=out)


def _crossover(out, dev) -> None:
    from tpusparse_torch.formats.sell import SellMatrix

    print("## Density crossover: SELL against dense (M = N = 4096, uniform, "
          "fp32 SpMV)\n", file=out)
    print("density crossover", file=sys.stderr)
    w = section_inputs("crossover")
    xt = torch.from_numpy(w["x"]).to(dev)
    print("| d(A) | dense_torch us | sell_cuda us | sell / dense | sell "
          "share |\n|---|---|---|---|---|", file=out)
    for d in w["densities"]:
        a = w["a_of"](d)
        at = torch.from_numpy(a).to(dev)
        rd = device_time(lambda: dense_torch(at, xt), name="dense",
                         bytes_moved=a.nbytes)
        sf = SellMatrix.from_dense(a, device=dev)
        rs = device_time(lambda: sf.spmv(xt), name="sell",
                         bytes_moved=format_bytes(sf))
        print(f"| {d} | {rd.seconds * 1e6:.2f} | {rs.seconds * 1e6:.2f} | "
              f"{rs.seconds / rd.seconds:.2f} | "
              f"{checked_share(rs.bytes_moved, rs.seconds, rs.name):.3f} |", file=out)
        print(f"  .. d={d}: dense {rd.seconds * 1e6:.1f} us, sell "
              f"{rs.seconds * 1e6:.1f} us", file=sys.stderr)
    print("\n`auto_format`'s density threshold (0.65) was measured on the "
          "TPU; this table is the card's own crossover (ROADMAP item 13).\n",
          file=out)


def _training(out, dev) -> None:
    from tpusparse_torch.autodiff import trainable_linear
    from tpusparse_torch.bench.shard_overhead import SPIN
    from tpusparse_torch.formats.csr import CsrMatrix

    print("## Training: fwd+bwd step, M = N = 4096, d = 0.5 fp32 "
          "(trainable_linear)\n", file=out)
    print("training", file=sys.stderr)
    w = section_inputs("training")
    apply, params, _, _ = trainable_linear(CsrMatrix.from_dense(w["a"]),
                                           device=dev)
    xt = torch.from_numpy(w["x"]).to(dev).requires_grad_()
    targets = [params["vals"], params["vals_t"], xt]
    slots = params["vals"].numel()
    # autograd's host code outlasts the default spin: wait longer before
    # each timed call, so the events bracket device work only
    fwd = device_time(lambda: apply(params, xt.detach()), name="fwd",
                      bytes_moved=slots * 5, spin=SPIN)

    def step():
        y = apply(params, xt)
        return torch.autograd.grad(y.sum(), targets)

    bwd = device_time(step, name="fwd+bwd", spin=SPIN)
    print("| pass | per call |\n|---|---|", file=out)
    print(f"| forward (K1) | {fwd.seconds * 1e6:.2f} us, share "
          f"{checked_share(fwd.bytes_moved, fwd.seconds, fwd.name):.3f} |", file=out)
    print(f"| fwd+bwd (dx and both value gradients: K1 x 2, K10 x 2) | "
          f"{bwd.seconds * 1e6:.2f} us ({bwd.seconds / fwd.seconds:.1f}x "
          f"fwd) |\n", file=out)


def _solver(out, dev) -> None:
    from tpusparse_torch.formats.auto import auto_format
    from tpusparse_torch.solve import cg

    n = SOLVER_SIDE ** 2
    print(f"## Solver: CG on a 5-point Laplacian, {n:,} unknowns "
          f"(solve.py)\n", file=out)
    print("solver", file=sys.stderr)
    w = section_inputs("solver")
    lap = w["csr"]
    s = auto_format(lap, device=dev)
    b = torch.from_numpy(w["b"]).to(dev)
    k1, k2 = SOLVER_ITERS
    # the slope between two fixed iteration counts (tol = 0): one iteration
    # without the set-up both calls share
    t1, t2 = (device_time(lambda k=k: cg(s, b, tol=0.0, maxiter=k),
                          name=f"cg[{k}]", reps=5).seconds for k in (k1, k2))
    per_iter = (t2 - t1) / (k2 - k1)
    fmt_bytes = format_bytes(s)
    iter_bytes = fmt_bytes + 7 * n * 4     # + the iteration's vector passes
    print("| quantity | value |\n|---|---|", file=out)
    print(f"| matrix | {n:,} x {n:,}, nnz {lap.nnz:,}, routed to "
          f"{type(s).__name__} |", file=out)
    print(f"| format bytes / iteration | {fmt_bytes / 1e6:.2f} MB (+ "
          f"{7 * n * 4 / 1e6:.2f} MB of vector passes) |", file=out)
    print(f"| CG iteration (event time, slope of {k1} and {k2} iterations)"
          f" | {per_iter * 1e6:.2f} us, {iter_bytes / per_iter / 1e9:.0f} "
          f"GB/s, {checked_share(iter_bytes, per_iter, "CG iteration"):.3f} of the bytes bound |\n",
          file=out)


def _header(out) -> None:
    card = card_info()
    print(f"Card: `{card['line']}` (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); bytes bound at the published "
          f"{detect_hbm_gbps():.0f} GB/s. Times: CUDA events after a read "
          f"L2 flush, median of 20 calls (`bench/runner.py`), packing and "
          f"uploads left out. Reproduce: `python -m tpusparse_torch report` "
          f"(`--sections` splits a long run).\n", file=out)


def verify_docs(root: str | None = None,
                records: tuple[str, ...] = ()) -> list[str]:
    """The port's records against its documents; returns the problems
    (empty: clean). Reads only the port's own files:

    - every file that PERF.md, or the README's section on the port, cites
      in backticks (a path with an extension, ``:line`` suffixes dropped)
      exists: a path with a directory at the root or under
      ``tpusparse_torch/``, a bare file name anywhere in the tree. A bare
      ``.md`` name cites a document, not a file a claim rests on, and is
      not checked: a checkout of the code alone may come without PERF.md
      and the other documents at the root;
    - no record among ``records`` (JSON files a port bench wrote) holds a
      share of the bytes bound (a key naming ``roofline`` or ``share``)
      above ``ARTIFACT_SHARE``.
    """
    import json
    import os
    import re

    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    problems: list[str] = []
    texts = {}
    perf = os.path.join(root, "PERF.md")
    if os.path.exists(perf):
        with open(perf) as f:
            texts["PERF.md"] = f.read()
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        with open(readme) as f:
            # code blocks left out: their comment lines read as headings
            text = re.sub(r"^```.*?^```", "", f.read(),
                          flags=re.MULTILINE | re.DOTALL)
        # the section whose heading names the port, to the next heading of
        # its level or above
        head = re.search(r"^(#+) .*tpusparse_torch.*$", text, re.MULTILINE)
        if head:
            nxt = re.compile(r"^#{1,%d} " % len(head.group(1)),
                             re.MULTILINE).search(text, head.end())
            texts["README.md"] = text[head.start():nxt.start() if nxt
                                      else len(text)]
    path_re = re.compile(r"`([A-Za-z0-9_./-]+\.(?:py|cu|cuh|cpp|md|json|mtx|"
                         r"npz|toml))(?::[0-9,-]+)?`")
    names: set[str] = set()
    for _, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != ".git"]
        names.update(files)
    for name, text in texts.items():
        for cited in sorted(set(path_re.findall(text))):
            if "/" not in cited and cited.endswith(".md"):
                continue
            found = cited in names if "/" not in cited else any(
                os.path.exists(os.path.join(root, sub, cited))
                for sub in ("", "tpusparse_torch"))
            if not found:
                problems.append(f"{name} cites {cited}, which does not exist")

    def walk(obj, where):
        if isinstance(obj, dict):
            for k, v in obj.items():
                if re.search(r"roofline|share", k) and \
                        isinstance(v, (int, float)) and v > ARTIFACT_SHARE:
                    problems.append(f"{where}: {k} = {v} is above "
                                    f"{ARTIFACT_SHARE}")
                walk(v, where)
        elif isinstance(obj, list):
            for v in obj:
                walk(v, where)

    for path in records:
        with open(path) as f:
            walk(json.load(f), path)
    return problems


def main(out=sys.stdout, sections=None, device=None) -> None:
    """The report's ``sections`` (None: all of ``SECTIONS``), in the JAX
    order, after ``verify_docs`` (raises on a problem)."""
    problems = verify_docs()
    if problems:
        raise RuntimeError("the port's documents cite missing files:\n  "
                           + "\n  ".join(problems))
    unknown = set(sections or ()) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}: one of "
                         f"{SECTIONS}")
    dev = resolve_device(device)
    stamp = run_id(dev)
    if sections is None:
        print("# tpusparse_torch: measured results\n", file=out)
    _header(out)
    for name in SECTIONS:
        if sections is not None and name not in sections:
            continue
        if name == "floors":
            floors(out, device=dev)
        else:
            globals()[f"_{name}"](out, dev)
        print(f"*(run: {stamp})*\n", file=out)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--sections", default=None,
                   help="comma list of " + ",".join(SECTIONS) + " (default "
                        "all)")
    args = p.parse_args()
    main(sections=set(args.sections.split(",")) if args.sections else None)
