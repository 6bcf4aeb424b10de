"""K9 (ASP) at every cluster size its C entry takes, on one GPU.

Usage (on the card, from the repository root):

    PYTHONPATH=. python scripts/k9_cluster_sweep.py [--variant DIR ...]
        [--out FILE]

The wrapper picks one cluster size (``kernels/asp_spmv.py:asp_shape``:
the largest of 8, 4, 2, 1 whose blocks fit the card's resident slots in
one wave). This script calls ``tps_asp_spmm`` directly with each size on
the headline ASP matrix (4096^2, d = 0.5, its full plan) and the 8192^2
powerlaw d = 0.15 matrix (this X's host plan), at B = 1 and 8, checks each
against the plain version (atol 1e-4), and prints the median device
microseconds (``bench.runner.device_time``: CUDA events after a read L2
flush) beside the size the wrapper picks, under the card's name and power
limit. Each ``--variant DIR`` (a copy of ``csrc/`` with K9's current C
interface, for instance with another ring depth) is built with the
package's nvcc flags and swept after the package's kernel, point by
point. ``--out`` also writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tpusparse_torch.bench.abba import build_other, load
from tpusparse_torch.bench.roofline import card_info
from tpusparse_torch.bench.runner import device_time
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.asp_spmv import (CLUSTERS, AspMatrix, asp_shape,
                                              asp_spmm_plain)
from tpusparse_torch.testing import generators

WORKLOADS = {"headline": dict(m=4096, n=4096, density=0.5,
                              distribution="uniform", seed=0),
             "skew": dict(m=8192, n=8192, density=0.15,
                          distribution="powerlaw", seed=0)}


def call(lib, f: AspMatrix, plan, k, x, cluster: int) -> torch.Tensor:
    n = f.shape[1]
    y = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    _build.check(lib.tps_asp_spmm(
        plan.data_ptr(), k.data_ptr(), f.a_pad.data_ptr(), x.data_ptr(),
        y.data_ptr(), *f.a_pad.shape, n, x.shape[0], x.shape[1],
        plan.numel(), cluster, x.device.index, _build.stream_of(x)),
        "asp_spmm")
    return y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_cluster_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_info()
    print(card["line"])
    sig = {"tps_asp_spmm": _build._SIGNATURES["tps_asp_spmm"]}
    libs = {"new": _build.lib()}
    libs.update({str(v): load(build_other(v, "variant", ["K9"]), sig)
                 for v in args.variant})
    rows = []
    for where, wl in WORKLOADS.items():
        a = generators.random_sparse_matrix(
            wl["m"], wl["n"], density=wl["density"], seed=wl["seed"],
            distribution=wl["distribution"])
        f = AspMatrix.from_dense(a, device=dev)
        for b in (1, 8):
            x = generators.random_sparse_batch(b, wl["m"], 0.5, wl["seed"])
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            plan = f._full_plan() if where == "headline" else \
                torch.from_numpy(f.plan(x)).to(dev)
            k = f._count(plan.numel())
            want = asp_spmm_plain(plan, k, f.a_pad, xt, n=f.shape[1])
            picked = asp_shape(f.shape[1], b, _build.sm_count(dev))[0]
            row = {"point": f"K9 {where} B={b}", "picked": picked, "us": {}}
            for name, lib in libs.items():
                for c in sorted(CLUSTERS):
                    y = call(lib, f, plan, k, xt, c)
                    err = float((y - want).abs().max())
                    if err > 1e-4:
                        raise AssertionError(f"{row['point']} {name} cluster"
                                             f" {c}: |kernel - plain| = "
                                             f"{err:.3e}")
                    row["us"][f"{name} C={c}"] = device_time(
                        lambda c=c, lib=lib: call(lib, f, plan, k, xt, c)
                    ).seconds * 1e6
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card["line"], "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
