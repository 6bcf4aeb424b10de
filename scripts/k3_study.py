"""K3 (AWSP) launch shapes and variants against its parent, in turns, on one
GPU; and the device plan's kernel beside its torch-ops form.

Usage (on the card, from the repository root):

    PYTHONPATH=. python scripts/k3_study.py --parent DIR
        [--slices auto,8,12] [--variant NAME=DIR ...] [--out FILE]

DIR holds the parent's ``csrc`` (``git archive <commit>
tpusparse_torch/csrc``); its K3 is called through its own C interface
(``bench.abba.parent_awsp``). The package's K3 is called through its C
entry with each ``--slices`` count (``auto``: the wrapper's
``awsp_slices``), and each ``--variant NAME=DIR`` (a copy of ``csrc/``
with K3's current C interface and one change, for instance another ring
depth or a phase cut out) with the wrapper's count; variants' outputs are
not checked. The points: the full registry's ``awsp_cuda`` (4096^2,
d = 0.5, g = 8, its full plan) at B = 1, 2, 4 and 8, and the JAX package's
live-fraction sweep (``bench.abba.sweep_matrix``, g = 2, live 1/16 and
1/4, B = 1 and 8, this X's host plan). Each point is timed in turns
(every contestant, then again in reverse) with ``bench.runner
.device_time`` and each contestant's CUDA-kernel time per call
(``bench.profile.kernel_times``). Then the plan kernel
(``device_group_plan``) is held to ``device_group_plan_plain`` bit for bit
and both are timed at B = 1, 8 and 32 on the two matrices.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from tpusparse_torch.bench import abba
from tpusparse_torch.bench.profile import kernel_times
from tpusparse_torch.bench.roofline import card_info
from tpusparse_torch.bench.runner import device_time
from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.awsp_spmv import (_VALS_KIND, awsp_slices,
                                               device_group_plan,
                                               device_group_plan_plain)
from tpusparse_torch.kernels.dense import batch_tile
from tpusparse_torch.testing import generators


def call(lib, f, plan, k, x, slices):
    """K3's C entry with ``slices`` blocks a group (None: the wrapper's)."""
    nb, ntot, w, _ = f.vals.shape
    batch = x.shape[0]
    bt = batch_tile(batch)
    tiles = -(-batch // bt)
    if slices is None:
        slices = awsp_slices(nb, tiles, plan.numel() * f.g * w, bt,
                             f.vals.element_size(), _build.sm_count(x.device))
    part = torch.empty((slices, batch, nb * 128), device=x.device)
    y = torch.empty((batch, f.shape[1]), device=x.device)
    counters = _build.arrival_counters(x.device, nb * tiles)
    _build.check(lib.tps_awsp_spmm(
        plan.data_ptr(), k.data_ptr(), f.idx.data_ptr(), f.vals.data_ptr(),
        _VALS_KIND[f.vals.dtype], x.data_ptr(), part.data_ptr(), y.data_ptr(),
        counters.data_ptr(), nb, ntot, f.g, plan.numel(), w, batch,
        x.shape[1], slices, f.shape[1], x.device.index,
        _build.stream_of(x)), "awsp")
    return y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--slices", default="auto")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_study: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_info()["line"], flush=True)
    parent = abba.load(abba.build_other(args.parent, "parent", ["K3"]),
                       abba.PARENT_SIGNATURES["K3"])
    mine = {"tps_awsp_spmm": _build._SIGNATURES["tps_awsp_spmm"]}
    contest = [(f"new S={s}", _build.lib(), None if s == "auto" else int(s))
               for s in args.slices.split(",")]
    for spec in args.variant:
        name, path = spec.split("=", 1)
        contest.append((name, abba.load(abba.build_other(Path(path), name,
                                                         ["K3"]), mine),
                        None))
    a = generators.random_sparse_matrix(4096, 4096, density=0.5, seed=0)
    fh = AwspMatrix.from_dense(a, g=8, device=dev)
    fs = AwspMatrix.from_dense(abba.sweep_matrix(), g=2, device=dev)
    points = [(f"headline B={b}", fh, fh._full_plan(), fh._count(4),
               abba._x(b, 4096, 0, dev)) for b in (1, 2, 4, 8)]
    for live in (0.0625, 0.25):
        for b in (1, 8):
            x = abba.x_pool(4096, 16, 256, live, b)
            plan = torch.from_numpy(fs.plan(x)).to(dev)
            points.append((f"sweep live={live} B={b}", fs, plan,
                           fs._count(plan.numel()),
                           torch.from_numpy(x).to(dev)))
    rows = []
    for name, f, plan, k, x in points:
        fns = [("parent", lambda f=f, plan=plan, k=k, x=x: abba.parent_awsp(
            parent, f, plan, k, x))]
        fns += [(label, lambda lib=lib, f=f, plan=plan, k=k, x=x, s=s:
                 call(lib, f, plan, k, x, s)) for label, lib, s in contest]
        ref = fns[0][1]()
        for label, fn in fns[1:1 + len(args.slices.split(","))]:
            err = float((fn() - ref).abs().max())
            if err > 1e-4:
                raise AssertionError(f"{name} {label}: {err:.3e}")
        order = fns + fns[::-1]
        t = [device_time(fn).seconds * 1e6 for _, fn in order]
        n = len(fns)
        row = {"point": name,
               "us": {lab: (t[i] + t[2 * n - 1 - i]) / 2
                      for i, (lab, _) in enumerate(fns)},
               "kernel_us": {lab: sum(kernel_times(
                   lambda ff, xx, fn=fn: fn(), None, x).values())
                   for lab, fn in fns}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for f, label in ((fh, "headline g=8"), (fs, "sweep g=2")):
        for b in (1, 8, 32):
            x = torch.from_numpy(generators.random_sparse_batch(
                b, 4096, 0.5, 0)).to(dev)
            got = device_group_plan(x, f.n_groups, f.span)
            want = device_group_plan_plain(x, f.n_groups, f.span)
            if not all(torch.equal(u, v) for u, v in zip(got, want)):
                raise AssertionError(f"plan kernel {label} B={b}")
            row = {"plan": label, "B": b,
                   "kernel_us": sum(kernel_times(
                       lambda ff, xx: device_group_plan(x, f.n_groups,
                                                        f.span),
                       None, x).values()),
                   "plain_kernels_us": sum(kernel_times(
                       lambda ff, xx: device_group_plan_plain(
                           x, f.n_groups, f.span), None, x).values()),
                   "event_us": device_time(lambda: device_group_plan(
                       x, f.n_groups, f.span)).seconds * 1e6}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
