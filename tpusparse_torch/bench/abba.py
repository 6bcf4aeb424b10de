"""Parent against new kernels on one GPU, timed in turns: parent, new, new,
parent (A B B A).

Usage (on the card, from the repository root):

    python -m tpusparse_torch.bench.abba --parent DIR [--points K3,K5]
        [--variant DIR ...] [--out FILE]
    python -m tpusparse_torch.bench.abba --parent DIR --points K4,K6,K7

DIR holds the parent's ``csrc`` sources (for instance unpacked with
``git archive <commit> tpusparse_torch/csrc``). The sources of the chosen
points' kernels are built with the package's nvcc flags into
``DIR/_build/libparent.so``. A kernel whose C interface is the package's
own is called through the package's wrapper with the parent library in the
place of the package's (K1, K2, K6, K7, K9, K11, K12). K3, K4 and K5 are
called through the interface they had before their redesign: K3
(``awsp_spmv.cu``) with ``_build.split_work`` slices, a partial buffer and
its reduce kernel, and its device plan in torch ops
(``device_group_plan_plain``); K4 (``rsell_spmv.cu``) with the pack's
per-batch-tile plans and no source lanes (the output in the pack's column
order); K5 (``permute.cu``) on one joined array. The new kernels are the
package's own.

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
sorted pack (the router's skew path), in the pack's column order, at B = 1
and 8, beside cuSPARSE and (at the headline) K1 on the SELL pack of the
same A; K9 on the headline workload's ASP matrix (the full registry's
``asp_cuda``, its full plan) and on the skew matrix (this X's host plan),
at B = 1 and 8, beside cuBLAS, K2 on the same dense A and (at the
headline) K6 on the full registry's ``bsr_cuda`` pack; K3 on the full
registry's ``awsp_cuda`` (the headline workload, g = 8, its full plan) at
B = 1 and 8 beside K1 on the SELL pack of the same A and cuSPARSE, and on
the JAX package's live-fraction sweep (``tpusparse/bench/dynamic.py:
run_awsp_sweep``: 4096^2, d = 0.5, g = 2, X live in a random
ceil(live * 16) of the 16 groups, the pattern shared across the batch,
``_x_pool``) at live 1/16, 1/4, 1/2 and 1 and B = 1 and 8, each two ways:
the public call on a CUDA X (its device plan and all) and the kernel with
this X's exact host plan; K5 on the skew matrix's sorted RSELL pack
through ``RsellMatrix.spmm`` (the parent: K4 then K5; the new: K4 with the
unpermute in its second kernel) beside K4 in the pack's column order, and
on binned SELL (the skew matrix and the headline workload; the parent: K1
a bucket, ``torch.cat``, K5; the new: K1 a bucket, K5 on the buckets in
place), at B = 1 and 8. ``--points`` picks kernels (default K3,K5).

At each point it checks parent and new against each other (atol 1e-4),
then times A, B, B, A with ``bench.runner``'s ``device_time`` (median of
20 calls, read-flushed L2, a ~0.5 ms wait before each so that the host has
enqueued the whole call), then the library call (cuSPARSE CSR for K1,
K3, K4, K5, K7, K11 and K12, cuBLAS for K2, K6 and K9) and the yardsticks
once each, and each contestant's device time in CUDA kernels per call
(``bench.profile.kernel_times``: ``torch.profiler`` after the same L2
flush; the new one's also kernel by kernel). Where a point knows the bytes
its function must move it prints the bound (bytes / the card's published
HBM rate) and the new call's share of it. It then counts, with
``cuobjdump -sass``, the tensor-core (HMMA), asynchronous-copy (LDGSTS,
UBLKCP, UTMALDG), mbarrier (SYNCS), cluster-barrier (UCGABAR) and
shared-atomic instructions of each kernel of both libraries. It prints a
Markdown table headed by the card's name and power limit, and writes every
number as JSON to FILE. Each ``--variant DIR`` (a tree with the current C
interface, for instance a copy with one phase of a kernel cut out) joins
the turns as a further contestant, in the middle: A B V .. V B A; its
results are not checked.
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
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpusparse_torch.bench import report
from tpusparse_torch.bench.profile import kernel_times
from tpusparse_torch.bench.roofline import card_info, detect_hbm_gbps
from tpusparse_torch.bench.runner import device_time
from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.formats.bell import BellMatrix
from tpusparse_torch.formats.binned import BinnedSellMatrix
from tpusparse_torch.formats.bsr import BsrMatrix
from tpusparse_torch.formats.rsell import RsellMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.formats.tcsr import TcsrMatrix
from tpusparse_torch.kernels import _build, block_items
from tpusparse_torch.kernels import rsell_spmv as k4
from tpusparse_torch.kernels.asp_spmv import AspMatrix, asp_spmm
from tpusparse_torch.kernels.awsp_spmv import (_VALS_KIND, awsp_spmm,
                                               device_group_plan_plain)
from tpusparse_torch.kernels.bell_spmv import bell_spmm
from tpusparse_torch.kernels.bsell_spmv import bsell_spmm
from tpusparse_torch.kernels.bsr_spmv import bsr_spmm
from tpusparse_torch.kernels.dense import batch_tile, dense_cuda, dense_torch
from tpusparse_torch.kernels.rsell_spmv import rsell_spmm
from tpusparse_torch.kernels.sell_mxu_spmm import sell_mxu_spmm
from tpusparse_torch.kernels.sell_spmv import sell_spmm
from tpusparse_torch.testing import generators

_P, _I = ctypes.c_void_p, ctypes.c_int
# Each kernel's sources (a K5 point runs K4 as well).
SOURCES = {"K1": ("sell_spmv.cu",), "K12": ("bell_spmv.cu",),
           "K2": ("dense.cu",), "K11": ("sell_mxu_spmm.cu",),
           "K6": ("bsr_spmv.cu",), "K7": ("bsell_spmv.cu",),
           "K4": ("rsell_spmv.cu",), "K9": ("asp_spmv.cu",),
           "K3": ("awsp_spmv.cu",), "K5": ("permute.cu", "rsell_spmv.cu")}
# The C interface of the kernels this PR redesigned, as the parent has it;
# every other kernel's is the package's own.
PARENT_SIGNATURES = {
    # plan, count, idx, vals, vals_kind, x, part, y, nb, ntot, g, plan_len,
    # w, batch, ldx, slices, per_slice, n, device, stream
    "K3": {"tps_awsp_spmm": [_P] * 4 + [_I] + [_P] * 3 + [_I] * 11 + [_P]},
    # items, gptr, ct, idx, vals, x, part, y, nitems, batch, ldx, n,
    # device, stream
    "K4": {"tps_rsell_spmm": [_P] * 8 + [_I] * 5 + [_P]},
    # y, src, out, batch, ldy, n, device, stream
    "K5": {"tps_permute_columns": [_P] * 3 + [_I] * 4 + [_P],
           "tps_rsell_spmm": [_P] * 8 + [_I] * 5 + [_P]},
}
ENTRIES = {"K1": "tps_sell_spmm", "K12": "tps_bell_spmm",
           "K2": "tps_dense_spmm", "K11": "tps_sell_mxu_spmm",
           "K6": "tps_bsr_spmm", "K7": "tps_bsell_spmm",
           "K4": "tps_rsell_spmm", "K9": "tps_asp_spmm",
           "K3": "tps_awsp_spmm", "K5": "tps_permute_columns"}
# the router's skew workload (chip_smoke.py's skew path)
SKEW = dict(m=8192, n=8192, density=0.15, distribution="powerlaw", seed=0)
# the JAX package's AWSP live-fraction sweep (tpusparse/bench/dynamic.py)
SWEEP = dict(m=4096, n=4096, d=0.5, g=2, seed=11,
             lives=(0.0625, 0.25, 0.5, 1.0))
# the wait before each timed call: binned SELL's calls take ~200 us of host
# time to enqueue (a K1 wrapper a bucket, then K5), twice the default's
SPIN = 1_000_000
SASS_NAMES = (r"sell_ring|sell_partial|bell_kernel|bell_partial|dense|mxu"
              r"|bsr|bsell|rsell|asp|awsp|group_plan|permute|reduce")


class Point(NamedTuple):
    """One comparison: the parent's and the new call, the library call,
    the yardsticks {label: call}, and the bytes the function must move
    (None where not counted)."""
    name: str
    old: Callable
    new: Callable
    lib: Callable
    yard: dict
    nbytes: int | None = None


def build_other(src: Path, stem: str, kernels) -> Path:
    """DIR's sources of ``kernels``, built into DIR/_build/lib<stem>.so with
    the package's nvcc flags, one nvcc a source, all at once."""
    out = src / "_build"
    out.mkdir(exist_ok=True)
    cc = _build.nvcc()
    objs, procs = [], []
    for name in sorted({s for k in kernels for s in SOURCES[k]}):
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
    """A library's entries, and the package library's error strings, in the
    place of ``_build.lib()``."""

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


def parent_awsp(so, f: AwspMatrix, plan, k, x):
    """The earlier K3: split_work slices of the full plan's windows into a
    partial buffer, then its reduce kernel."""
    dev = x.device
    nb, ntot, w, _ = f.vals.shape
    n, batch, plan_len = f.shape[1], x.shape[0], plan.numel()
    per, slices = _build.split_work(plan_len * f.g, nb, dev)
    part = torch.empty((slices, batch, nb * 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    _check(so.tps_awsp_spmm(
        plan.data_ptr(), k.data_ptr(), f.idx.data_ptr(), f.vals.data_ptr(),
        _VALS_KIND[f.vals.dtype], x.data_ptr(), part.data_ptr(), y.data_ptr(),
        nb, ntot, f.g, plan_len, w, batch, x.shape[1], slices, per, n,
        dev.index, _build.stream_of(x)), "parent K3")
    return y


def parent_rsell(so, r: RsellMatrix, x):
    """The earlier K4: the pack's plan for this batch tile, the output in
    the pack's column order (batch, n_padded)."""
    dev = x.device
    np_ = r.padded[1]
    batch = x.shape[0]
    items, gptr = block_items.resolve(
        "parent K4", r._work, r.cj, np_ // 128, 8, batch_tile(batch), dev,
        k4.SHAPES, cols=k4.ITEM_INTS)
    part = torch.empty((items.shape[0], batch, 128), dtype=torch.float32,
                       device=dev)
    y = torch.empty((batch, np_), dtype=torch.float32, device=dev)
    _check(so.tps_rsell_spmm(
        items.data_ptr(), gptr.data_ptr(), r.ct.data_ptr(), r.idx.data_ptr(),
        r.vals.data_ptr(), x.data_ptr(), part.data_ptr(), y.data_ptr(),
        items.shape[0], batch, x.shape[1], np_, dev.index,
        _build.stream_of(x)), "parent K4")
    return y


def parent_permute(so, y, src):
    """The earlier K5 on one joined array."""
    out = torch.empty((y.shape[0], src.numel()), dtype=torch.float32,
                      device=y.device)
    _check(so.tps_permute_columns(
        y.data_ptr(), src.data_ptr(), out.data_ptr(), y.shape[0], y.shape[1],
        src.numel(), y.device.index, _build.stream_of(y)), "parent K5")
    return out


def _x(b: int, m: int, seed: int, dev) -> torch.Tensor:
    x = (generators.random_sparse_vector(m, 0.5, seed)[None, :] if b == 1
         else generators.random_sparse_batch(b, m, 0.5, seed))
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _csr_of_at(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev) \
        .to_sparse_csr()


def _skew(dev):
    a = generators.random_sparse_matrix(
        SKEW["m"], SKEW["n"], density=SKEW["density"], seed=SKEW["seed"],
        distribution=SKEW["distribution"])
    return a, [(b, _x(b, SKEW["m"], SKEW["seed"], dev)) for b in (1, 8)]


def x_pool(m: int, ng: int, span: int, live: float, batch: int,
           seed: int = 7) -> np.ndarray:
    """The first X of the JAX sweep's pool (``tpusparse/bench/dynamic.py:
    _x_pool``): live in a random ``max(1, round(live * ng))`` of the ng
    groups, uniform values there, the pattern shared by the batch rows;
    (batch, m)."""
    rng = np.random.default_rng(seed)
    k = max(1, int(round(live * ng)))
    groups = rng.choice(ng, size=k, replace=False)
    x = np.zeros((batch, m), dtype=np.float32)
    for gi in groups:
        lo = gi * span
        x[:, lo:min(lo + span, m)] = rng.uniform(
            -1.0, 1.0, size=(batch, min(span, m - lo)))
    return x


def sweep_matrix() -> np.ndarray:
    """The JAX sweep's A (``tpusparse/bench/dynamic.py:_awsp_case``)."""
    rng = np.random.default_rng(SWEEP["seed"])
    a = rng.uniform(-1.0, 1.0, size=(SWEEP["m"], SWEEP["n"])) \
        .astype(np.float32)
    a *= rng.uniform(size=a.shape) < SWEEP["d"]
    return a


def awsp_bytes(f: AwspMatrix, live_groups: int, batch: int, plan_len: int
               ) -> int:
    """The live groups' tiles, x, y and the plan (ids and count)."""
    nb, _, w, lanes = f.vals.shape
    tiles = nb * live_groups * f.g * w * lanes * (f.vals.element_size() + 1)
    return tiles + 4 * (batch * f.shape[0] + batch * f.shape[1]
                        + plan_len + 1)


def awsp_points(dev, parent, a, at_csr, heads):
    """The K3 points: the full registry's ``awsp_cuda`` at the headline,
    then the live-fraction sweep, each live point by its public call and
    by the kernel with the exact host plan."""
    out = []
    fh = AwspMatrix.from_dense(a, g=8, device=dev)
    s = SellMatrix.from_dense(a, device=dev)
    plan, k = fh._full_plan(), fh._count(fh.n_groups)
    for b, xt in heads:
        out.append(Point(
            f"K3 headline g=8 B={b}",
            lambda xt=xt: parent_awsp(parent, fh, plan, k, xt),
            lambda xt=xt: awsp_spmm(plan, k, fh.idx, fh.vals, xt, g=8,
                                    n=4096),
            lambda xt=xt: at_csr @ xt.T,
            {"K1": lambda xt=xt: sell_spmm(s.idx, s.vals, xt, n=4096)},
            awsp_bytes(fh, fh.n_groups, b, plan.numel())))
    a_l = sweep_matrix()
    f = AwspMatrix.from_dense(a_l, g=SWEEP["g"], device=dev)
    csr = _csr_of_at(a_l, dev)
    ng, span = f.n_groups, f.span
    for live in SWEEP["lives"]:
        for b in (1, 8):
            x = x_pool(SWEEP["m"], ng, span, live, b)
            xt = torch.from_numpy(x).to(dev)
            hp = torch.from_numpy(f.plan(x)).to(dev)
            hk = f._count(hp.numel())
            nbytes = awsp_bytes(f, hp.numel(), b, hp.numel())
            where = f"live={live} B={b}"

            def dev_parent(xt=xt):
                p, kk = device_group_plan_plain(xt, ng, span)
                return parent_awsp(parent, f, p, kk, xt)
            out.append(Point(
                f"K3 {where} device plan", dev_parent,
                lambda xt=xt: f.spmm(xt), lambda xt=xt: csr @ xt.T, {},
                nbytes + 4 * (ng + 1)))
            out.append(Point(
                f"K3 {where} host plan",
                lambda xt=xt, hp=hp, hk=hk: parent_awsp(parent, f, hp, hk,
                                                        xt),
                lambda xt=xt, hp=hp, hk=hk: awsp_spmm(
                    hp, hk, f.idx, f.vals, xt, g=f.g, n=f.shape[1]),
                lambda xt=xt: csr @ xt.T, {}, nbytes))
    return out


def permute_points(dev, parent, a, at_csr, heads):
    """The K5 points: the skew matrix's sorted RSELL pack through
    ``RsellMatrix.spmm``, then binned SELL on the skew matrix and on the
    headline workload."""
    out = []
    a_s, s_heads = _skew(dev)
    s_csr = _csr_of_at(a_s, dev)
    r = RsellMatrix.from_dense(a_s, device=dev)
    if r.perm_src is None:
        raise AssertionError("the skew pack should be sorted")
    for b, xt in s_heads:
        out.append(Point(
            f"K5 skew rsell B={b}",
            lambda xt=xt: parent_permute(parent, parent_rsell(parent, r, xt),
                                         r.perm_src),
            lambda xt=xt: r.spmm(xt), lambda xt=xt: s_csr @ xt.T,
            {"K4 pack order": lambda xt=xt: rsell_spmm(
                r.cj, r.ct, r.idx, r.vals, xt, n_padded=r.padded[1],
                plan=r._work)}))
    for where, mat, m_csr, xs in (("skew", a_s, s_csr, s_heads),
                                  ("headline", a, at_csr, heads)):
        f = BinnedSellMatrix.from_dense(mat, device=dev)
        for b, xt in xs:
            def old(f=f, xt=xt):
                parts = [sell_spmm(k["idx"], k["vals"], xt)
                         for k in f.buckets]
                return parent_permute(parent, torch.cat(parts, dim=1),
                                      f.perm_src)
            out.append(Point(f"K5 binned {where} B={b}", old,
                             lambda f=f, xt=xt: f.spmm(xt),
                             lambda xt=xt, m_csr=m_csr: m_csr @ xt.T, {}))
    return out


def skew_points(dev, parent, kernels, a, a_dev, at_csr, heads):
    """The K4 and K9 points."""
    out = []
    a_s, s_heads = _skew(dev)
    wls = [("headline", a, a_dev, at_csr, heads),
           ("skew", a_s, torch.from_numpy(a_s).to(dev), _csr_of_at(a_s, dev),
            s_heads)]
    for where, mat, m_dev, m_csr, xs in wls:
        n = mat.shape[1]
        if "K4" in kernels:
            r = RsellMatrix.from_dense(mat, device=dev)
            yard = {}
            if where == "headline":
                s = SellMatrix.from_dense(mat, device=dev)
                yard = {"K1": s}
            for b, xt in xs:
                out.append(Point(
                    f"K4 {where} B={b}",
                    lambda r=r, xt=xt: parent_rsell(parent, r, xt),
                    lambda r=r, xt=xt: rsell_spmm(
                        r.cj, r.ct, r.idx, r.vals, xt, n_padded=r.padded[1],
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
                new = (lambda f=f, plan=plan, k=k, xt=xt, n=n: asp_spmm(
                    plan, k, f.a_pad, xt, n=n))
                calls = {"K2": lambda xt=xt, m_dev=m_dev: dense_cuda(m_dev,
                                                                    xt)}
                calls.update({name: (lambda fn=fn, xt=xt: fn(xt))
                              for name, fn in yard.items()})
                out.append(Point(
                    f"K9 {where} B={b}", through(parent, new), new,
                    lambda xt=xt, m_dev=m_dev: dense_torch(m_dev, xt),
                    calls))
    return out


def block_points(dev, parent, kernels, a, a_dev, at_csr, heads):
    """The K6 and K7 points."""
    out = []
    blocky = generators.block_pruned_matrix(4096, 4096, block=128,
                                            keep_frac=0.3, fill=0.5, seed=9)
    wls = [("blockpruned", blocky, torch.from_numpy(blocky).to(dev),
            _csr_of_at(blocky, dev), 128),
           ("headline", a, a_dev, at_csr, 512)]
    for where, mat, m_dev, m_csr, block_m in wls:
        if "K6" in kernels:
            f = BsrMatrix.from_dense(mat, block_m=block_m, device=dev)
            for b, xt in heads:
                new = (lambda f=f, xt=xt: bsr_spmm(
                    f.bi, f.bj, f.blocks, xt, n_padded=4096, plan=f._work))
                out.append(Point(
                    f"K6 {where} block_m={block_m} B={b}",
                    through(parent, new), new,
                    lambda xt=xt, m_dev=m_dev: dense_torch(m_dev, xt),
                    {"K2": lambda xt=xt, m_dev=m_dev: dense_cuda(m_dev, xt)}))
        if "K7" in kernels:
            t = TcsrMatrix.from_dense(mat, expect_batch=1, device=dev)
            if t.bsr is not None:
                raise AssertionError(f"{where}: TCSR holds a dense tier")
            s = SellMatrix.from_dense(mat, device=dev)
            for b, xt in heads:
                new = (lambda t=t, xt=xt: bsell_spmm(
                    t.s_bi, t.s_bj, t.idx, t.vals, xt, n_padded=4096,
                    plan=t._work))
                out.append(Point(
                    f"K7 {where} W={t.w} B={b}", through(parent, new), new,
                    lambda xt=xt, m_csr=m_csr: m_csr @ xt.T,
                    {"K1": lambda s=s, xt=xt: sell_spmm(s.idx, s.vals, xt,
                                                        n=4096)}))
    return out


def points(dev, parent, kernels) -> list[Point]:
    """Every point of ``kernels``; ``new`` calls the package's wrappers."""
    out = []
    a = generators.random_sparse_matrix(4096, 4096, density=0.5, seed=0)
    a_dev = torch.from_numpy(a).to(dev)
    at_csr = _csr_of_at(a, dev)
    heads = [(b, _x(b, 4096, 0, dev)) for b in (1, 8)]

    def compare(name, new, lib):      # a kernel with the package's interface
        out.append(Point(name, through(parent, new), new, lib, {}))

    if "K1" in kernels:
        s = SellMatrix.from_dense(a, device=dev)
        for b, xt in heads:
            compare(f"K1 headline B={b}",
                    lambda xt=xt: sell_spmm(s.idx, s.vals, xt, n=4096),
                    lambda xt=xt: at_csr @ xt.T)
    if "K12" in kernels:
        f = BellMatrix.from_dense(a, device=dev)
        for b, xt in heads:
            compare(f"K12 headline B={b}",
                    lambda xt=xt: bell_spmm(f.bitmap, f.vals, xt,
                                            block_m=f.block_m, n=4096),
                    lambda xt=xt: at_csr @ xt.T)
    if "K2" in kernels:
        for b, xt in heads:
            compare(f"K2 B={b}", lambda xt=xt: dense_cuda(a_dev, xt),
                    lambda xt=xt: dense_torch(a_dev, xt))
    if "K1" in kernels or "K11" in kernels:
        for wl in report.workloads(dev):
            s, csr = wl["sell"], wl["at_csr"]
            for b in report.BATCHES:
                xt = torch.from_numpy(report.grid_batch(b)).to(dev)
                where = f"d={wl['density']} B={b}"
                lib = (lambda xt=xt, csr=csr: csr @ xt.T)
                if "K1" in kernels:
                    compare(f"K1 {where}", lambda s=s, xt=xt: sell_spmm(
                        s.idx, s.vals, xt, n=4096), lib)
                if "K11" in kernels:
                    compare(f"K11 {where}", lambda s=s, xt=xt: sell_mxu_spmm(
                        s.idx, s.vals, xt, n=4096), lib)
    if "K6" in kernels or "K7" in kernels:
        out += block_points(dev, parent, kernels, a, a_dev, at_csr, heads)
    if "K4" in kernels or "K9" in kernels:
        out += skew_points(dev, parent, kernels, a, a_dev, at_csr, heads)
    if "K3" in kernels:
        out += awsp_points(dev, parent, a, at_csr, heads)
    if "K5" in kernels:
        out += permute_points(dev, parent, a, at_csr, heads)
    return out


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


def _calls(fn):
    return lambda f, xx: fn()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--points", default="K3,K5",
                    help="kernels to compare, of " + ", ".join(SOURCES))
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
    hbm = detect_hbm_gbps() * 1e9
    names = sorted({ENTRIES[k] for k in kernels}
                   | {e for k in kernels for e in PARENT_SIGNATURES.get(k, {})})
    parent_sigs = {e: _build._SIGNATURES[e] for e in names}
    for k in kernels:
        parent_sigs.update(PARENT_SIGNATURES.get(k, {}))
    parent_lib = build_other(args.parent, "parent", kernels)
    parent = _Variant(load(parent_lib, parent_sigs), names)
    mine = {e: _build._SIGNATURES[e] for e in names}
    variants = [(str(v), _Variant(load(build_other(v, "variant", kernels),
                                       mine), names))
                for v in args.variant]
    rows = []
    for p in points(dev, parent, kernels):
        yp, yn = p.old(), p.new()
        torch.cuda.synchronize()
        diff = float((yp.double() - yn.double()).abs().max())
        if diff > 1e-4:
            raise AssertionError(f"{p.name}: |parent - new| = {diff:.3e}")
        extra = [(vn, through(v, p.new)) for vn, v in variants]
        order = [p.old, p.new] + [f for _, f in extra]
        order = order + order[::-1]
        t = [device_time(f, spin=SPIN).seconds * 1e6 for f in order]
        lib_us = device_time(p.lib, spin=SPIN).seconds * 1e6
        yard_us = {k: device_time(f, spin=SPIN).seconds * 1e6
                   for k, f in p.yard.items()}
        by_kernel = kernel_times(_calls(p.new), None, yp)
        kern_us = {label: sum(kernel_times(_calls(fn), None, yp).values())
                   for label, fn in [("parent", p.old)] + extra
                   + list(p.yard.items())}
        kern_us["new"] = sum(by_kernel.values())
        row = {"point": p.name, "A1": t[0], "B1": t[1], "B2": t[-2],
               "A2": t[-1], "parent_us": (t[0] + t[-1]) / 2,
               "new_us": (t[1] + t[-2]) / 2, "library_us": lib_us,
               "yardsticks_us": yard_us, "max_abs_diff": diff,
               "kernel_us": kern_us, "new_kernels_us": by_kernel,
               "variants_us": {vn: (t[2 + i] + t[-3 - i]) / 2
                               for i, (vn, _) in enumerate(extra)}}
        row["new_over_parent"] = row["new_us"] / row["parent_us"]
        if p.nbytes is not None:
            row["bytes"] = p.nbytes
            row["bound_us"] = p.nbytes / hbm * 1e6
            row["share"] = row["bound_us"] / row["new_us"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    sass = {"parent": sass_counts(parent_lib),
            "new": sass_counts(_build.build())}
    print(f"\n## A B B A on {card['line']} (us per call)\n")
    print("| point | A1 | B1 | B2 | A2 | new / parent | bound, share | "
          "library | yardsticks | variants | kernels |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        bound = (f"{r['bound_us']:.2f}, {r['share']:.3f}" if "bound_us" in r
                 else "—")
        print(f"| {r['point']} | {r['A1']:.2f} | {r['B1']:.2f} | "
              f"{r['B2']:.2f} | {r['A2']:.2f} | {r['new_over_parent']:.3f} "
              f"| {bound} | {r['library_us']:.2f} | "
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
