"""Parent against new K2 (dense) and K11 (SELL decompress-to-dense) on one
GPU, timed in turns: parent, new, new, parent (A B B A).

Usage (on the card, from the repository root):

    python -m tpusparse_torch.bench.abba --parent DIR [--out FILE]

DIR holds an earlier version's ``dense.cu`` and ``sell_mxu_spmm.cu`` with
the headers they include (for instance unpacked with ``git archive
<commit> tpusparse_torch/csrc``). Both are built with the same nvcc flags
into ``DIR/_build/libparent.so`` and called through the earlier C
interface (a second kernel adds the slices), with the launch shape of
``_build.split_work``. The new kernels are the package's own.

Points: K2 on the headline workload (4096^2, d = 0.5, seed 0) at B = 1 and
8; K11 at the six floors points (``bench.report``: 4096^2, d in {0.1,
0.5}, B in {1, 8, 32}). At each point it checks parent and new against
each other (atol 1e-4), then times A, B, B, A with ``bench.runner``'s
``device_time`` (median of 20 calls, read-flushed L2), then the library
call (cuBLAS for K2, cuSPARSE CSR for K11) once, and each contestant's
device time in CUDA kernels per call (``bench.profile.kernel_times``:
``torch.profiler`` after the same L2 flush). It then counts, with
``cuobjdump -sass``, the tensor-core (HMMA), asynchronous-copy (LDGSTS,
UBLKCP) and shared-atomic instructions of each K2 and K11 kernel of both
libraries. It prints a Markdown table headed by the card's name and power
limit, and writes every number as JSON to FILE. Each ``--variant DIR``
(a tree with the current C interface, for instance a copy with one phase
of a kernel cut out) joins the turns as a third contestant, in the middle:
A B V .. V B A; its results are not checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tpusparse_torch.bench import report
from tpusparse_torch.bench.profile import kernel_times
from tpusparse_torch.bench.roofline import card_info
from tpusparse_torch.bench.runner import device_time
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.dense import dense_cuda, dense_torch
from tpusparse_torch.kernels.sell_mxu_spmm import sell_mxu_spmm
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import cdiv

_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    # a, x, part, y, m, n, batch, slices, per_slice, device, stream
    "tps_dense_spmm": [_P] * 4 + [_I] * 6 + [_P],
    # idx, vals, x, part, y, nb, nt, w, batch, ldx, slices, per_slice, n,
    # device, stream
    "tps_sell_mxu_spmm": [_P] * 5 + [_I] * 9 + [_P],
}


def build_other(src: Path, stem: str) -> Path:
    """DIR's dense.cu and sell_mxu_spmm.cu, built into DIR/_build/lib<stem>.so
    with the package's nvcc flags."""
    out = src / "_build"
    out.mkdir(exist_ok=True)
    cc = _build.nvcc()
    objs = []
    procs = []
    for name in ("dense.cu", "sell_mxu_spmm.cu"):
        obj = out / (Path(name).stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [cc, *_build.FLAGS, "-c", str(src / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"build of {src} failed:\n{text}")
    lib = out / f"lib{stem}.so"
    subprocess.run([cc, "-shared", "-o", str(lib), *map(str, objs)],
                   check=True)
    return lib


def load(path: Path, signatures) -> ctypes.CDLL:
    so = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        getattr(so, name).argtypes = argtypes
        getattr(so, name).restype = ctypes.c_int
    return so


class _Variant:
    """A variant's two entries, and the package library's error strings."""

    def __init__(self, so):
        self.so = so
        self.tps_dense_spmm = so.tps_dense_spmm
        self.tps_sell_mxu_spmm = so.tps_sell_mxu_spmm
        self.tps_error_string = _build.lib().tps_error_string


def through(so, fn):
    """fn() with the package's wrappers calling ``so`` (a variant built
    with the current C interface) instead of the package's library."""
    variant = _Variant(so)

    def run():
        keep = _build.lib
        _build.lib = lambda: variant
        try:
            return fn()
        finally:
            _build.lib = keep
    return run


def parent_dense(so, a, x):
    dev = a.device
    m, n = a.shape
    batch = x.shape[0]
    per, slices = _build.split_work(m, cdiv(n, 128), dev)
    part = torch.empty((slices, batch, n), dtype=torch.float32, device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = so.tps_dense_spmm(a.data_ptr(), x.data_ptr(), part.data_ptr(),
                           y.data_ptr(), m, n, batch, slices, per, dev.index,
                           _build.stream_of(a))
    if rc:
        raise RuntimeError(f"parent K2: CUDA error {rc}")
    return y


def parent_mxu(so, idx, vals, x, n):
    dev = x.device
    nb, nt, w, _ = vals.shape
    batch = x.shape[0]
    per, slices = _build.split_work(nt, nb, dev)
    part = torch.empty((slices, batch, nb * 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = so.tps_sell_mxu_spmm(idx.data_ptr(), vals.data_ptr(), x.data_ptr(),
                              part.data_ptr(), y.data_ptr(), nb, nt, w, batch,
                              x.shape[1], slices, per, n, dev.index,
                              _build.stream_of(x))
    if rc:
        raise RuntimeError(f"parent K11: CUDA error {rc}")
    return y


def points(dev, so):
    """(name, parent, new, library) for every point; ``new`` calls the
    package's wrappers."""
    out = []
    a = generators.random_sparse_matrix(4096, 4096, density=0.5, seed=0)
    a_dev = torch.from_numpy(a).to(dev)
    for b in (1, 8):
        x = (generators.random_sparse_vector(4096, 0.5, 0)[None, :]
             if b == 1 else generators.random_sparse_batch(8, 4096, 0.5, 0))
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        out.append((f"K2 B={b}",
                    lambda xt=xt: parent_dense(so, a_dev, xt),
                    lambda xt=xt: dense_cuda(a_dev, xt),
                    lambda xt=xt: dense_torch(a_dev, xt)))
    for wl in report.workloads(dev):
        s, at_csr = wl["sell"], wl["at_csr"]
        for b in report.BATCHES:
            xt = torch.from_numpy(report.grid_batch(b)).to(dev)
            out.append((
                f"K11 d={wl['density']} B={b}",
                lambda s=s, xt=xt: parent_mxu(so, s.idx, s.vals, xt, 4096),
                lambda s=s, xt=xt: sell_mxu_spmm(s.idx, s.vals, xt, n=4096),
                lambda xt=xt, at_csr=at_csr: at_csr @ xt.T))
    return out


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            keep = re.search(r"dense|mxu", name)
            name = name if keep else None
            if name:
                out[name] = {"HMMA": 0, "HMMA_TF32": 0, "LDGSTS": 0,
                             "UBLKCP": 0, "ATOMS": 0}
        elif name:
            for key in ("LDGSTS", "UBLKCP", "ATOMS"):
                out[name][key] += key in line
            if "HMMA" in line:
                out[name]["HMMA"] += 1
                out[name]["HMMA_TF32"] += "TF32" in line
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="a tree with the current C interface, timed as "
                    "a third contestant (repeatable; not checked)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench.abba: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_info()
    parent_lib = build_other(args.parent, "parent")
    so = load(parent_lib, PARENT_SIGNATURES)
    mine = {k: _build._SIGNATURES[k] for k in PARENT_SIGNATURES}
    variants = [(str(v), load(build_other(v, "variant"), mine))
                for v in args.variant]
    rows = []
    for name, parent, new, lib in points(dev, so):
        yp, yn = parent(), new()
        torch.cuda.synchronize()
        diff = float((yp.double() - yn.double()).abs().max())
        if diff > 1e-4:
            raise AssertionError(f"{name}: |parent - new| = {diff:.3e}")
        order = [parent, new] + [through(v, new) for _, v in variants]
        order = order + order[::-1]
        t = [device_time(f).seconds * 1e6 for f in order]
        lib_us = device_time(lib).seconds * 1e6
        kern_us = {label: sum(kernel_times(lambda f, xx: fn(), None,
                                           yp).values())
                   for label, fn in [("parent", parent), ("new", new)]
                   + [(vn, through(v, new)) for vn, v in variants]}
        row = {"point": name, "A1": t[0], "B1": t[1], "B2": t[-2], "A2": t[-1],
               "parent_us": (t[0] + t[-1]) / 2, "new_us": (t[1] + t[-2]) / 2,
               "library_us": lib_us, "max_abs_diff": diff,
               "kernel_us": kern_us,
               "variants_us": {vn: (t[2 + i] + t[-3 - i]) / 2
                               for i, (vn, _) in enumerate(variants)}}
        row["new_over_parent"] = row["new_us"] / row["parent_us"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    sass = {"parent": sass_counts(parent_lib),
            "new": sass_counts(_build.build())}
    print(f"\n## A B B A on {card['line']} (us per call)\n")
    print("| point | A1 | B1 | B2 | A2 | new / parent | library |\n"
          "|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['point']} | {r['A1']:.2f} | {r['B1']:.2f} | "
              f"{r['B2']:.2f} | {r['A2']:.2f} | {r['new_over_parent']:.3f} "
              f"| {r['library_us']:.2f} |"
              + "".join(f" {v}: {t:.2f} |" for v, t in r["variants_us"].items())
              + " kernels: " + ", ".join(f"{k} {t:.2f}"
                                         for k, t in r["kernel_us"].items()))
    for which, funcs in sass.items():
        for fn, counts in sorted(funcs.items()):
            print(f"sass {which} {fn}: {json.dumps(counts)}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card["line"], "rows": rows,
                                        "sass": sass}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
