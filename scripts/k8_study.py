"""K8 (DIA) launch shapes, timed in turns on one GPU: the tile T (positions
a block) and the blocks an SM, which set the shared-memory budget of its
plan.

Usage (on the card, from the repository root):

    PYTHONPATH=. python scripts/k8_study.py [--shapes 1024x4,2048x2]
        [--variant NAME=DIR ...] [--out FILE]

At the two K8 points of ``bench.abba`` (``laplace2d-1M``,
``stencil27-104``; x ~50% nonzero, seed 0) it builds one plan for each
shape TxBLOCKS (the plan stages at most SM_SMEM / BLOCKS less 1 KB and
leaves the rest of its windows in global memory), checks each against the
package's plan's output bit for bit, and times every plan through
``dia_spmv`` in turns (all, then again in reverse) with
``bench.runner.device_time``, and each one's CUDA-kernel time per call
(``bench.profile.kernel_times``), beside the package's own plan. Each
``--variant NAME=DIR`` (a copy of ``csrc/`` with K8's current C interface
and one change, for instance a phase cut out) is timed at every shape too;
its outputs are not checked. Last, as a floor for a stream of the same
bytes on this card, ``Tensor.copy_`` of half the Laplacian's bytes (read
and written). It prints one JSON line per point and a Markdown table
headed by the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from tpusparse_torch.bench import abba
from tpusparse_torch.bench.abba import BANDED
from tpusparse_torch.bench.profile import kernel_times
from tpusparse_torch.bench.roofline import card_info, detect_hbm_gbps
from tpusparse_torch.bench.runner import device_time
from tpusparse_torch.formats.dia import DiaMatrix
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.dia_spmv import dia_plan, dia_spmv
from tpusparse_torch.testing import generators

SHAPES = ("512x2", "768x2", "1024x8", "1024x4", "1024x2", "1152x2",
          "1536x2", "2048x2")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_study: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_info()
    hbm = detect_hbm_gbps() * 1e9
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.shapes.split(",")]
    variants = {}
    for spec in args.variant:
        vname, vdir = spec.split("=", 1)
        lib = abba.build_other(Path(vdir), "variant_" + vname, ["K8"])
        variants[vname] = abba._Variant(
            abba.load(lib, {"tps_dia_spmv": _build._SIGNATURES["tps_dia_spmv"]}),
            ["tps_dia_spmv"])
    rows = []
    for name, (dims, pts) in BANDED.items():
        d = DiaMatrix.from_csr(generators.stencil_csr(dims, points=pts),
                               device=dev)
        n = d.shape[1]
        x = torch.from_numpy(generators.random_sparse_vector(n, 0.5, 0)) \
            .to(dev)
        want = d.spmv(x)
        plans = {"package": d.plan}
        for t, b in shapes:
            plans[f"T={t} {b}/SM"] = dia_plan(d.offsets, d.sym, tile=t,
                                              blocks=b)
        calls = {}
        for label, p in list(plans.items()):
            fn = (lambda p=p: dia_spmv(d.offsets, d.vals, x, sym=d.sym, n=n,
                                       plan=p))
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {label}: not the same bits")
            calls[label] = fn
            for vname, v in variants.items():
                plans[f"{label} {vname}"] = p
                calls[f"{label} {vname}"] = abba.through(v, fn)
        order = list(calls) + list(calls)[::-1]
        times = {label: [] for label in calls}
        for label in order:
            times[label].append(device_time(calls[label]).seconds * 1e6)
        bound = (d.device_bytes() + 8 * n) / hbm * 1e6
        for label, p in plans.items():
            kern = sum(kernel_times(lambda f, xx, c=calls[label]: c(), None,
                                    x).values())
            row = {"point": name, "plan": label, "tile": p.tile,
                   "smem_bytes": p.smem_bytes,
                   "blocks_per_sm": min(8, _build.SM_SMEM
                                        // (p.smem_bytes + 1024)),
                   "global_terms": sum(t[3] < 0 or t[4] < 0
                                       for t in p.terms),
                   "us": sum(times[label]) / 2, "turns_us": times[label],
                   "kernel_us": kern, "bound_us": bound,
                   "share": bound / kern}
            rows.append(row)
            print(json.dumps(row), flush=True)
    half = torch.empty((1 << 20) * 5 // 2, device=dev)
    dst = torch.empty_like(half)
    floor = {"us": device_time(lambda: dst.copy_(half)).seconds * 1e6,
             "kernel_us": sum(kernel_times(lambda f, xx: dst.copy_(half),
                                           None, half).values()),
             "bytes": 2 * half.numel() * 4}
    print(json.dumps({"copy_floor": floor}))
    print(f"\n## K8 plans on {card['line']} (us per call)\n")
    print("| point | plan | smem B | blocks/SM | global terms | event us | "
          "kernel us | bound us | kernel share |\n|---|---|---|---|---|---|"
          "---|---|---|")
    for r in rows:
        print(f"| {r['point']} | {r['plan']} | {r['smem_bytes']} | "
              f"{r['blocks_per_sm']} | {r['global_terms']} | {r['us']:.2f} | "
              f"{r['kernel_us']:.2f} | {r['bound_us']:.2f} | "
              f"{r['share']:.3f} |")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card["line"], "rows": rows,
                                        "copy_floor": floor}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
