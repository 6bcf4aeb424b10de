"""``python -m tpusparse_torch.bench.report``: the SpMM strategy floors.

Counterpart of ``floors`` in ``tpusparse/bench/report.py`` (the rest of
that report is not ported yet). On the JAX package's grid, M = N = 4096,
A uniform at d in {0.1, 0.5} (seed 0), X ~50% nonzero (seed 0),
B in {1, 8, 32}, it times four ways to compute ``Y = X @ A``:

- ``gather``: K1, the SELL gather kernel (``kernels/sell_spmv.py``);
- ``decompress``: K11, each SELL tile decompressed into a dense 128 x 128
  tile and multiplied over the batch on the tensor cores in 3xTF32
  (``kernels/sell_mxu_spmm.py``);
- ``dense``: cuBLAS in true fp32 (``dense_torch``, TF32 off);
- ``cusparse``: cuSPARSE CSR of A.T times X (the library call for the same
  function), timed here only.

``check_points`` holds K11 against its plain version (atol 1e-4) and the
float64 oracle (atol 1e-3) at every point; ``floors`` (after those checks,
unless told they were made) times the four with CUDA events after the
read-only L2 flush of ``bench.runner``, and prints a Markdown table
naming the card and its power limit, beside each point's bounds: the
function's (the SELL pack's bytes at 3.35 TB/s against 2*nnz*B flops at
the fp32 peak) and K11's own (its dense 2*M*N*B flops at that peak).
Needs a CUDA card: ``device_time`` raises without one.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np
import torch

from tpusparse_torch.bench.roofline import (card_info, detect_hbm_gbps,
                                            format_bytes)
from tpusparse_torch.bench.runner import device_time
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


def main() -> None:
    floors()


if __name__ == "__main__":
    main()
