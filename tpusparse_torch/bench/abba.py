"""Parent against new kernels on one GPU, timed in turns: parent, new, new,
parent (A B B A).

Usage (on the card, from the repository root):

    python -m tpusparse_torch.bench.abba --parent DIR [--points K1,K12]
        [--variant DIR ...] [--out FILE]
    python -m tpusparse_torch.bench.abba --parent DIR --points K6,K7
    python -m tpusparse_torch.bench.abba --parent DIR --points K4,K9

DIR holds an earlier version's ``csrc`` sources (for instance unpacked with
``git archive <commit> tpusparse_torch/csrc``). The sources of the chosen
points' kernels are built with the package's nvcc flags into
``DIR/_build/libparent.so``. K1 (``sell_spmv.cu``) and K12
(``bell_spmv.cu``) are called through the C interface they had before
their one-launch redesign: no arrival counters, the slices of
``_build.split_work`` added by a second, reduce kernel. K6
(``bsr_spmv.cu``) and K7 (``bsell_spmv.cu``) keep their C interface; the
parent is given the plan it was built for, one-tile items of
``rsell_spmv.device_work_plan``. K4 (``rsell_spmv.cu``) and K9
(``asp_spmv.cu``) are called through the C interface they had before their
redesign: K4 with the same one-plan-for-every-batch items and its ``ct``,
K9 with ``_build.split_work`` slices, a partial buffer and its reduce
kernel. K2 (``dense.cu``) and K11 (``sell_mxu_spmm.cu``) are called through
the current interface. The new kernels are the package's own.

Points: K1 on the headline workload (4096^2, d = 0.5, seed 0) at B = 1 and
8 and at the six floors points (``bench.report``: 4096^2, d in {0.1, 0.5},
B in {1, 8, 32}); K12 on the headline workload's BELL pack (block_m 512)
at B = 1 and 8; K2 on the headline workload at B = 1 and 8; K11 at the six
floors points; K6 on blockpruned-4096 (``block_pruned_matrix(4096, 4096,
block=128, keep_frac=0.3, fill=0.5, seed=9)``) as BSR at block_m 128 and
on the headline workload at block_m 512 (the full registry's ``bsr_cuda``),
at B = 1 and 8, beside K2 and cuBLAS on the same dense A; K7 on
blockpruned-4096's SELL tier (TCSR packed for B = 1) and on the headline
workload's TCSR pack (SELL tier only, the full registry's ``tcsr_cuda``),
at B = 1 and 8, beside K1 on the SELL pack of the same A and cuSPARSE;
K4 on the headline workload's RSELL pack (the full registry's
``rsell_cuda``, K4 alone) and on the 8192^2 powerlaw d = 0.15 matrix's
sorted pack (the router's skew path), at B = 1 and 8, beside cuSPARSE and
(at the headline) K1 on the SELL pack of the same A; K9 on the headline
workload's ASP matrix (the full registry's ``asp_cuda``, its full plan)
and on the skew matrix (this X's host plan), at B = 1 and 8, beside cuBLAS,
K2 on the same dense A and (at the headline) K6 on the full registry's
``bsr_cuda`` pack. ``--points`` picks kernels (default K1,K12). At each point
it checks parent and new against each other (atol 1e-4), then times A, B,
B, A with ``bench.runner``'s ``device_time`` (median of 20 calls,
read-flushed L2), then the library call (cuSPARSE CSR for K1, K4, K7,
K11 and K12, cuBLAS for K2, K6 and K9) and the yardstick kernels (K2 for
K6, K1 for K7, K1 for K4, K2 and K6 for K9) once each, and each
contestant's device time in CUDA kernels per
call (``bench.profile.kernel_times``: ``torch.profiler`` after the same L2
flush). It then counts, with ``cuobjdump -sass``, the tensor-core (HMMA),
asynchronous-copy (LDGSTS, UBLKCP, UTMALDG), mbarrier (SYNCS), cluster-barrier
(UCGABAR) and shared-atomic instructions of each kernel of both
libraries. It prints a Markdown table headed by the card's name and power
limit, and writes every number as JSON to FILE. Each ``--variant DIR`` (a
tree with the current C interface, for instance a copy with one phase of a
kernel cut out) joins the turns as a further contestant, in the middle:
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
from tpusparse_torch.formats.bell import BellMatrix
from tpusparse_torch.formats.bsr import BsrMatrix
from tpusparse_torch.formats.rsell import RsellMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.formats.tcsr import TcsrMatrix
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.asp_spmv import AspMatrix, asp_spmm
from tpusparse_torch.kernels.bell_spmv import bell_spmm
from tpusparse_torch.kernels.bsell_spmv import bsell_spmm
from tpusparse_torch.kernels.bsr_spmv import bsr_spmm
from tpusparse_torch.kernels.dense import dense_cuda, dense_torch
from tpusparse_torch.kernels.rsell_spmv import device_work_plan, rsell_spmm
from tpusparse_torch.kernels.sell_mxu_spmm import sell_mxu_spmm
from tpusparse_torch.kernels.sell_spmv import _VALS_KIND, sell_spmm
from tpusparse_torch.testing import generators

_P, _I = ctypes.c_void_p, ctypes.c_int
# The kernels' sources and the C interface each is called through in the
# parent: K1 and K12 as before their one-launch redesign, K4 and K9 as
# before theirs, K2, K11, K6 and K7 as now.
SOURCES = {"K1": "sell_spmv.cu", "K12": "bell_spmv.cu", "K2": "dense.cu",
           "K11": "sell_mxu_spmm.cu", "K6": "bsr_spmv.cu",
           "K7": "bsell_spmv.cu", "K4": "rsell_spmv.cu", "K9": "asp_spmv.cu"}
PARENT_SIGNATURES = {
    # idx, vals, vals_kind, x, scales, part, y, nb, nt, w, batch, ldx,
    # slices, per_slice, n, device, stream
    "K1": ("tps_sell_spmm", [_P, _P, _I, _P, _P, _P, _P] + [_I] * 9 + [_P]),
    # bitmap, vals, x, part, y, nb, mb, block_m, w, batch, ldx, slices,
    # per_slice, n, device, stream
    "K12": ("tps_bell_spmm", [_P] * 5 + [_I] * 10 + [_P]),
    "K6": ("tps_bsr_spmm", _build._SIGNATURES["tps_bsr_spmm"]),
    "K7": ("tps_bsell_spmm", _build._SIGNATURES["tps_bsell_spmm"]),
    "K2": ("tps_dense_spmm", _build._SIGNATURES["tps_dense_spmm"]),
    "K11": ("tps_sell_mxu_spmm", _build._SIGNATURES["tps_sell_mxu_spmm"]),
    # items, gptr, ct, idx, vals, x, part, y, nitems, batch, ldx, n,
    # device, stream
    "K4": ("tps_rsell_spmm", [_P] * 8 + [_I] * 5 + [_P]),
    # plan, count, a, x, part, y, lda, n, batch, ldx, plan_len, slices,
    # per_slice, device, stream
    "K9": ("tps_asp_spmm", [_P] * 6 + [_I] * 8 + [_P]),
}
# the router's skew workload (chip_smoke.py's skew path)
SKEW = dict(m=8192, n=8192, density=0.15, distribution="powerlaw", seed=0)
# kernels called through the current C interface in the parent
CURRENT = {"K2", "K11", "K6", "K7"}
SASS_NAMES = (r"sell_ring|sell_partial|bell_kernel|bell_partial|dense|mxu"
              r"|bsr|bsell|rsell|asp")


def build_other(src: Path, stem: str, kernels) -> Path:
    """DIR's sources of ``kernels``, built into DIR/_build/lib<stem>.so with
    the package's nvcc flags, one nvcc a source, all at once."""
    out = src / "_build"
    out.mkdir(exist_ok=True)
    cc = _build.nvcc()
    objs, procs = [], []
    for name in sorted({SOURCES[k] for k in kernels}):
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


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    so = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        getattr(so, name).argtypes = argtypes
        getattr(so, name).restype = ctypes.c_int
    return so


class _Variant:
    """A variant library's entries, and the package library's error
    strings, in the place of ``_build.lib()``."""

    def __init__(self, so, names):
        for name in names:
            setattr(self, name, getattr(so, name))
        self.tps_error_string = _build.lib().tps_error_string


def through(variant, fn):
    """fn() with the package's wrappers calling ``variant`` (a library with
    the current C interface) instead of the package's library."""

    def run():
        keep = _build.lib
        _build.lib = lambda: variant
        try:
            return fn()
        finally:
            _build.lib = keep
    return run


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def parent_sell(so, s: SellMatrix, x, n):
    """The earlier K1: split_work slices, then the reduce kernel."""
    dev = x.device
    nb, nt, w, _ = s.vals.shape
    batch = x.shape[0]
    per, slices = _build.split_work(nt, nb, dev)
    part = torch.empty((slices, batch, nb * 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    _check(so.tps_sell_spmm(
        s.idx.data_ptr(), s.vals.data_ptr(), _VALS_KIND[s.vals.dtype],
        x.data_ptr(), None, part.data_ptr(), y.data_ptr(), nb, nt, w, batch,
        x.shape[1], slices, per, n, dev.index, _build.stream_of(x)),
        "parent K1")
    return y


def parent_bell(so, f: BellMatrix, x, n):
    """The earlier K12: 64 columns a block, split_work slices, then the
    reduce kernel."""
    dev = x.device
    nb, mb, _, w = f.vals.shape
    batch = x.shape[0]
    per, slices = _build.split_work(mb, nb * 2, dev)
    part = torch.empty((slices, batch, nb * 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    _check(so.tps_bell_spmm(
        f.bitmap.data_ptr(), f.vals.data_ptr(), x.data_ptr(), part.data_ptr(),
        y.data_ptr(), nb, mb, f.block_m, w, batch, x.shape[1], slices, per, n,
        dev.index, _build.stream_of(x)), "parent K12")
    return y


def parent_bsr(so, f: BsrMatrix, x, n, plan):
    """The earlier K6 with its plan: one-tile items, then the group
    reduce kernel."""
    dev = x.device
    items, gptr = plan
    batch = x.shape[0]
    part = torch.empty((items.shape[0], batch, 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    _check(so.tps_bsr_spmm(
        items.data_ptr(), gptr.data_ptr(), f.bi.data_ptr(),
        f.blocks.data_ptr(), x.data_ptr(), part.data_ptr(), y.data_ptr(),
        items.shape[0], f.block_m, batch, x.shape[1], n, dev.index,
        _build.stream_of(x)), "parent K6")
    return y


def parent_bsell(so, t: TcsrMatrix, x, n, plan):
    """The earlier K7 with its plan: one-tile items, then the group reduce
    kernel."""
    dev = x.device
    items, gptr = plan
    batch = x.shape[0]
    part = torch.empty((items.shape[0], batch, 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    _check(so.tps_bsell_spmm(
        items.data_ptr(), gptr.data_ptr(), t.s_bi.data_ptr(),
        t.idx.data_ptr(), t.vals.data_ptr(), x.data_ptr(), part.data_ptr(),
        y.data_ptr(), items.shape[0], t.w, batch, x.shape[1], n, dev.index,
        _build.stream_of(x)), "parent K7")
    return y


def parent_rsell(so, r: RsellMatrix, x, n, plan):
    """The earlier K4: one plan of whole-chunk items for every batch, the
    chunks' windows read through ct, then the group reduce kernel."""
    dev = x.device
    items, gptr = plan
    batch = x.shape[0]
    part = torch.empty((items.shape[0], batch, 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    _check(so.tps_rsell_spmm(
        items.data_ptr(), gptr.data_ptr(), r.ct.data_ptr(), r.idx.data_ptr(),
        r.vals.data_ptr(), x.data_ptr(), part.data_ptr(), y.data_ptr(),
        items.shape[0], batch, x.shape[1], n, dev.index,
        _build.stream_of(x)), "parent K4")
    return y


def parent_asp(so, f: AspMatrix, plan, k, x):
    """The earlier K9: split_work slices into a partial buffer, then the
    reduce kernel."""
    dev = x.device
    n = f.shape[1]
    batch, plan_len = x.shape[0], plan.numel()
    per, slices = _build.split_work(plan_len, -(-n // 128), dev)
    part = torch.empty((slices, batch, n), dtype=torch.float32, device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    _check(so.tps_asp_spmm(
        plan.data_ptr(), k.data_ptr(), f.a_pad.data_ptr(), x.data_ptr(),
        part.data_ptr(), y.data_ptr(), f.a_pad.shape[1], n, batch,
        x.shape[1], plan_len, slices, per, dev.index, _build.stream_of(x)),
        "parent K9")
    return y


def skew_points(dev, parent, kernels, a, a_dev, at_csr, heads):
    """The K4 and K9 points: (name, parent, new, library, {yardstick:
    call})."""
    out = []
    a_s = generators.random_sparse_matrix(
        SKEW["m"], SKEW["n"], density=SKEW["density"], seed=SKEW["seed"],
        distribution=SKEW["distribution"])
    s_dev = torch.from_numpy(a_s).to(dev)
    s_csr = torch.from_numpy(np.ascontiguousarray(a_s.T)).to(dev) \
        .to_sparse_csr()
    s_heads = []
    for b in (1, 8):
        x = (generators.random_sparse_vector(SKEW["m"], 0.5, SKEW["seed"])
             [None, :] if b == 1 else generators.random_sparse_batch(
                 b, SKEW["m"], 0.5, SKEW["seed"]))
        s_heads.append((b, torch.from_numpy(np.ascontiguousarray(x)).to(dev)))
    wls = [("headline", a, a_dev, at_csr, heads),
           ("skew", a_s, s_dev, s_csr, s_heads)]
    for where, mat, m_dev, m_csr, xs in wls:
        n = mat.shape[1]
        if "K4" in kernels:
            r = RsellMatrix.from_dense(mat, device=dev)
            np_ = r.padded[1]
            plan = device_work_plan(r.cj.cpu().numpy(), np_ // 128, dev)
            yard = {}
            if where == "headline":
                s = SellMatrix.from_dense(mat, device=dev)
                yard = {"K1": s}
            for b, xt in xs:
                out.append((
                    f"K4 {where} B={b}",
                    lambda r=r, xt=xt, plan=plan, np_=np_: parent_rsell(
                        parent, r, xt, np_, plan),
                    lambda r=r, xt=xt, np_=np_: rsell_spmm(
                        r.cj, r.ct, r.idx, r.vals, xt, n_padded=np_,
                        plan=r._work),
                    lambda xt=xt, m_csr=m_csr: m_csr @ xt.T,
                    {k: (lambda s=s, xt=xt, n=n: sell_spmm(
                        s.idx, s.vals, xt, n=n)) for k, s in yard.items()}))
        if "K9" in kernels:
            f = AspMatrix.from_dense(mat, device=dev)
            yard = {}
            if where == "headline":
                bsr = BsrMatrix.from_dense(mat, block_m=512, device=dev)
                yard["K6"] = lambda xt, bsr=bsr, n=n: bsr_spmm(
                    bsr.bi, bsr.bj, bsr.blocks, xt, n_padded=bsr.padded[1],
                    n=n, plan=bsr._work)
            for b, xt in xs:
                plan = f._full_plan() if where == "headline" else \
                    torch.from_numpy(f.plan(xt.cpu().numpy())).to(dev)
                k = f._count(plan.numel())
                calls = {"K2": lambda xt=xt, m_dev=m_dev: dense_cuda(m_dev,
                                                                    xt)}
                calls.update({name: (lambda fn=fn, xt=xt: fn(xt))
                              for name, fn in yard.items()})
                out.append((
                    f"K9 {where} B={b}",
                    lambda f=f, plan=plan, k=k, xt=xt: parent_asp(
                        parent, f, plan, k, xt),
                    lambda f=f, plan=plan, k=k, xt=xt, n=n: asp_spmm(
                        plan, k, f.a_pad, xt, n=n),
                    lambda xt=xt, m_dev=m_dev: dense_torch(m_dev, xt),
                    calls))
    return out


def _headline_x(b: int, dev) -> torch.Tensor:
    x = (generators.random_sparse_vector(4096, 0.5, 0)[None, :]
         if b == 1 else generators.random_sparse_batch(b, 4096, 0.5, 0))
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def block_points(dev, parent, kernels, a, a_dev, at_csr, heads):
    """The K6 and K7 points: (name, parent, new, library, {yardstick:
    call})."""
    out = []
    blocky = generators.block_pruned_matrix(4096, 4096, block=128,
                                            keep_frac=0.3, fill=0.5, seed=9)
    b_dev = torch.from_numpy(blocky).to(dev)
    b_csr = torch.from_numpy(np.ascontiguousarray(blocky.T)).to(dev) \
        .to_sparse_csr()
    wls = [("blockpruned", blocky, b_dev, b_csr, 128),
           ("headline", a, a_dev, at_csr, 512)]
    for where, mat, m_dev, m_csr, block_m in wls:
        if "K6" in kernels:
            f = BsrMatrix.from_dense(mat, block_m=block_m, device=dev)
            plan = device_work_plan(f.bj.cpu().numpy(), 32, dev)
            for b, xt in heads:
                new = (lambda f=f, xt=xt: bsr_spmm(
                    f.bi, f.bj, f.blocks, xt, n_padded=4096, plan=f._work))
                out.append((
                    f"K6 {where} block_m={block_m} B={b}",
                    lambda f=f, xt=xt, plan=plan: parent_bsr(parent, f, xt,
                                                             4096, plan),
                    new, lambda xt=xt, m_dev=m_dev: dense_torch(m_dev, xt),
                    {"K2": lambda xt=xt, m_dev=m_dev: dense_cuda(m_dev, xt)}))
        if "K7" in kernels:
            t = TcsrMatrix.from_dense(mat, expect_batch=1, device=dev)
            if t.bsr is not None:
                raise AssertionError(f"{where}: TCSR holds a dense tier")
            s = SellMatrix.from_dense(mat, device=dev)
            plan = device_work_plan(t.s_bj.cpu().numpy(), 32, dev)
            for b, xt in heads:
                new = (lambda t=t, xt=xt: bsell_spmm(
                    t.s_bi, t.s_bj, t.idx, t.vals, xt, n_padded=4096,
                    plan=t._work))
                out.append((
                    f"K7 {where} W={t.w} B={b}",
                    lambda t=t, xt=xt, plan=plan: parent_bsell(parent, t, xt,
                                                               4096, plan),
                    new, lambda xt=xt, m_csr=m_csr: m_csr @ xt.T,
                    {"K1": lambda s=s, xt=xt: sell_spmm(s.idx, s.vals, xt,
                                                        n=4096)}))
    return out


def points(dev, parent, kernels):
    """(name, parent, new, library, {yardstick: call}) for every point of
    ``kernels``; ``new`` calls the package's wrappers."""
    out = []
    a = generators.random_sparse_matrix(4096, 4096, density=0.5, seed=0)
    a_dev = torch.from_numpy(a).to(dev)
    at_csr = torch.from_numpy(np.ascontiguousarray(a.T)).to(dev) \
        .to_sparse_csr()
    heads = [(b, _headline_x(b, dev)) for b in (1, 8)]
    if "K1" in kernels:
        s = SellMatrix.from_dense(a, device=dev)
        for b, xt in heads:
            out.append((f"K1 headline B={b}",
                        lambda xt=xt: parent_sell(parent, s, xt, 4096),
                        lambda xt=xt: sell_spmm(s.idx, s.vals, xt, n=4096),
                        lambda xt=xt: at_csr @ xt.T))
    if "K12" in kernels:
        f = BellMatrix.from_dense(a, device=dev)
        for b, xt in heads:
            out.append((f"K12 headline B={b}",
                        lambda xt=xt: parent_bell(parent, f, xt, 4096),
                        lambda xt=xt: bell_spmm(f.bitmap, f.vals, xt,
                                                block_m=f.block_m, n=4096),
                        lambda xt=xt: at_csr @ xt.T))
    if "K2" in kernels:
        for b, xt in heads:
            out.append((f"K2 B={b}",
                        through(parent, lambda xt=xt: dense_cuda(a_dev, xt)),
                        lambda xt=xt: dense_cuda(a_dev, xt),
                        lambda xt=xt: dense_torch(a_dev, xt)))
    if "K1" in kernels or "K11" in kernels:
        for wl in report.workloads(dev):
            s, csr = wl["sell"], wl["at_csr"]
            for b in report.BATCHES:
                xt = torch.from_numpy(report.grid_batch(b)).to(dev)
                where = f"d={wl['density']} B={b}"
                if "K1" in kernels:
                    out.append((
                        f"K1 {where}",
                        lambda s=s, xt=xt: parent_sell(parent, s, xt, 4096),
                        lambda s=s, xt=xt: sell_spmm(s.idx, s.vals, xt,
                                                     n=4096),
                        lambda xt=xt, csr=csr: csr @ xt.T))
                if "K11" in kernels:
                    out.append((
                        f"K11 {where}",
                        through(parent, lambda s=s, xt=xt: sell_mxu_spmm(
                            s.idx, s.vals, xt, n=4096)),
                        lambda s=s, xt=xt: sell_mxu_spmm(s.idx, s.vals, xt,
                                                         n=4096),
                        lambda xt=xt, csr=csr: csr @ xt.T))
    if "K6" in kernels or "K7" in kernels:
        out += block_points(dev, parent, kernels, a, a_dev, at_csr, heads)
    if "K4" in kernels or "K9" in kernels:
        out += skew_points(dev, parent, kernels, a, a_dev, at_csr, heads)
    return [p if len(p) == 5 else p + ({},) for p in out]


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if re.search(SASS_NAMES, name) else None
            if name:
                out[name] = {"HMMA": 0, "HMMA_TF32": 0, "LDGSTS": 0,
                             "UBLKCP": 0, "UTMALDG": 0, "SYNCS": 0,
                             "UCGABAR": 0, "ATOMS": 0}
        elif name:
            for key in ("LDGSTS", "UBLKCP", "UTMALDG", "SYNCS", "UCGABAR",
                        "ATOMS"):
                out[name][key] += key in line
            if "HMMA" in line:
                out[name]["HMMA"] += 1
                out[name]["HMMA_TF32"] += "TF32" in line
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--points", default="K1,K12",
                    help="kernels to compare, of K1, K12, K2, K11, K6, K7, "
                    "K4, K9")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="a tree with the current C interface, timed as "
                    "a further contestant (repeatable; not checked)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench.abba: needs a CUDA card", file=sys.stderr)
        return 2
    kernels = args.points.split(",")
    if not set(kernels) <= set(SOURCES):
        ap.error(f"--points: {kernels} not in {list(SOURCES)}")
    dev = torch.device("cuda")
    card = card_info()
    parent_lib = build_other(args.parent, "parent", kernels)
    parent_sigs = dict(PARENT_SIGNATURES[k] for k in kernels)
    parent = load(parent_lib, parent_sigs)
    if CURRENT & set(kernels):   # the current interface
        parent = _Variant(parent, parent_sigs)
    names = [PARENT_SIGNATURES[k][0] for k in kernels]
    mine = {k: _build._SIGNATURES[k] for k in names}
    variants = [(str(v), _Variant(load(build_other(v, "variant", kernels),
                                       mine), names))
                for v in args.variant]
    rows = []
    for name, old, new, lib, yard in points(dev, parent, kernels):
        yp, yn = old(), new()
        torch.cuda.synchronize()
        diff = float((yp.double() - yn.double()).abs().max())
        if diff > 1e-4:
            raise AssertionError(f"{name}: |parent - new| = {diff:.3e}")
        extra = [(vn, through(v, new)) for vn, v in variants]
        order = [old, new] + [f for _, f in extra]
        order = order + order[::-1]
        t = [device_time(f).seconds * 1e6 for f in order]
        lib_us = device_time(lib).seconds * 1e6
        yard_us = {k: device_time(f).seconds * 1e6 for k, f in yard.items()}
        kern_us = {label: sum(kernel_times(lambda f, xx, fn=fn: fn(), None,
                                           yp).values())
                   for label, fn in [("parent", old), ("new", new)] + extra
                   + list(yard.items())}
        row = {"point": name, "A1": t[0], "B1": t[1], "B2": t[-2], "A2": t[-1],
               "parent_us": (t[0] + t[-1]) / 2, "new_us": (t[1] + t[-2]) / 2,
               "library_us": lib_us, "yardsticks_us": yard_us,
               "max_abs_diff": diff, "kernel_us": kern_us,
               "variants_us": {vn: (t[2 + i] + t[-3 - i]) / 2
                             for i, (vn, _) in enumerate(extra)}}
        row["new_over_parent"] = row["new_us"] / row["parent_us"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    sass = {"parent": sass_counts(parent_lib),
            "new": sass_counts(_build.build())}
    print(f"\n## A B B A on {card['line']} (us per call)\n")
    print("| point | A1 | B1 | B2 | A2 | new / parent | library | yardsticks "
          "| variants | kernels |\n|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['point']} | {r['A1']:.2f} | {r['B1']:.2f} | "
              f"{r['B2']:.2f} | {r['A2']:.2f} | {r['new_over_parent']:.3f} "
              f"| {r['library_us']:.2f} | "
              + ", ".join(f"{k} {t:.2f}"
                          for k, t in r["yardsticks_us"].items()) + " | "
              + ", ".join(f"{v} {t:.2f}" for v, t in r["variants_us"].items())
              + " | " + ", ".join(f"{k} {t:.2f}"
                                  for k, t in r["kernel_us"].items()) + " |")
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
