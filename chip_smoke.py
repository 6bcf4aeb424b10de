#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpusparse_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the twelve hand-written kernels from ``tpusparse_torch/csrc`` with
``nvcc`` (one process per source, first use), then, at the reference
workload (``Y = X @ A``, fp32, M = N = 4096, ~50% sparsity in A and X,
seed 0) for B = 1 and B = 8:

1. drives the headline path through the public API (``SpmvTester`` over the
   headline registry: ``dense_torch``, ``dense_cuda``, ``sell_cuda``,
   ``awsp_cuda``), with every launch counter set to 0 just before and read
   just after; each kernel must have launched;
2. holds each kernel against its plain PyTorch version on the card and
   against the float64 oracle (atol 1e-3), and times kernel, plain version,
   and one library call (cuSPARSE CSR for K1/K3, cuBLAS for K2) with CUDA
   events after an L2 flush; K2 is one launch a call, its rows streamed
   through a cp.async ring and its split-K sum fused (the last block of
   each column group adds the slices in a fixed order); K1 runs its
   128-thread body here (up to 8 batch rows; from 9 rows a ring of
   bulk-copied tiles reads the pack once for every 32 rows, phase 15);
3. runs AWSP on a structured X (a quarter of the 128-row windows live, g = 1)
   through the device plan under ``torch.cuda.set_sync_debug_mode("error")``,
   plus an all-zero X: each call one launch of the plan kernel
   (``csrc/group_plan.cu``) and one of K3, which splits the live slot rows
   on the device, streams them through a ring of bulk-copied stages and sums
   its parts in the same launch;
3b. drives K3 on the JAX package's live-fraction sweep (4096^2, d = 0.5,
   g = 2; live 0, 1/16, 1/4, 1/2 and 1 of the 16 groups, B = 1 and 8, the
   pattern shared by the batch) through the public call on a CUDA X, counted;
   then holds the plan kernel to ``device_group_plan_plain`` bit for bit,
   and K3 with this X's exact host plan and through the public call to its
   plain version and the oracle at every point, times both beside the
   bound (the live groups' tiles, x, y and the plan), and times the plan
   kernel at B = 8;
4. holds K1's bf16 and int8 storage lanes against their plain versions
   (atol 1e-4; these lanes are outside the 1e-3 contract);

and then, on the router's skew workload (8192 x 8192 powerlaw, d = 0.15,
seed 0; X ~50% nonzero):

5. drives the skew path through the public API: ``auto_format`` must pick
   RSELL at B = 1 and ASP at B = 8, and ``spmv``/``spmm`` on them must
   launch K4 (RSELL, whose second kernel writes the sorted pack's output in
   the user's column order) and K9 (ASP), and no K5, with every launch
   counter set to 0 just before and read just after;
6. holds K4, K5 and K9 at B = 1 and 8 against their plain versions and the
   float64 oracle, with the same timings and a library call each (cuSPARSE
   CSR for K4, ``torch.index_select`` for K5, cuBLAS for K9);
7. runs ASP through the device plan on a structured X (a quarter of the
   windows live) under ``torch.cuda.set_sync_debug_mode("error")``, plus an
   all-zero X; times the sorted skew pack's public call against K4 alone in
   the pack's column order (what the fused unpermute costs); and runs K4 on
   a flat (run = 1) sorted pack (its unpermute in K4, the same bits as K4
   then K5) and on an unsorted pack, with no K5 launch either way;

and then the router's banded and block-structured routes:

8. the block-structured path on blockpruned-4096
   (``block_pruned_matrix(4096, 4096, block=128, keep_frac=0.3, fill=0.5,
   seed=9)``, X ~50% nonzero): ``auto_format`` must pick TCSR at B = 1
   (SELL tier only) and at B = 8 (dense tier only); ``spmv`` at B = 1 must
   launch K7 and ``spmm`` at B = 8 must launch K6, every launch counter set
   to 0 just before and read just after;
9. the banded path on the 1M-unknown 2D 5-point Laplacian
   (``stencil_csr((1024, 1024))``, as CSR): ``auto_format`` must pick DIA
   (sym, offsets (0, 1, 1024)); ``spmv`` must launch K8, and ``spmm`` at
   B = 8 (the shifted torch form, no kernel) must match the oracle, which
   is computed in float64 from the CSR through scipy, never densified;
10. holds K6, K7 and K8 at B = 1 and 8 against their plain versions and the
    oracle, with the same timings and a library call each (cuBLAS for K6,
    cuSPARSE CSR for K7 and K8; K8 takes one vector, so B = 8 is eight
    launches), and runs a mixed-tier TCSR pack (the split charge set to 0)
    and a BSR pack with block_m = 40 against the oracle;

and then the training path, on the headline matrix as a trainable weight
(BENCH.md §Training: 4096 x 4096, d = 0.5, fp32):

11. ``trainable_linear`` (one twin pack, its host time printed): a
    backward at B = 1 and B = 8 with x requiring grad launches K1 twice and
    K10 twice (every launch counter set to 0 just before and read just
    after); dx matches the float64 oracle g @ A.T, ``dvals`` and
    ``dvals_t`` scattered back to dense through the signed planes match
    mask(A) * (x.T @ g) in float64 (atol 1e-3), pad slots are exactly 0.
    Then example 08's MLP at this width: ``SparseLinear.from_csr(csr,
    use_bias=True, activation=torch.relu)`` (4096 -> 4096) and
    ``nn.Linear(4096, 64)``, 5 ``torch.optim.SGD`` steps on a B = 8 ~50%-
    sparse X toward a fixed target: the loss falls, each step launches K1
    once and K10 twice (X is data), the backward runs under
    ``torch.cuda.set_sync_debug_mode("error")``, and ``resync`` leaves
    ``vals_t`` equal to the re-tied copy;
12. holds K10 at B = 1 and 8 against its plain version and the oracle,
    times it, its plain version and ``torch.sparse.sampled_addmm``
    (cuSPARSE SDDMM on A's CSR, the yardstick), and times the forward and
    the fwd+bwd step beside their bytes bounds;

and then the JAX package's full bench registry and its floors study:

13. the full registry's own entries (``ell_torch``, ``bell_cuda``,
    ``sell_binned_cuda``, ``bsr_cuda``, ``tcsr_cuda``, ``rsell_cuda``,
    ``asp_cuda``) at the headline workload, B = 1 and 8, through
    ``SpmvTester`` against the oracle, each timed (its artifact check on
    ``format_bytes``: BELL's ``read_bytes``), every launch counter set to 0
    just before each entry and read just after: ``bell_cuda`` must launch
    K12, ``sell_binned_cuda`` K1 and K5, ``bsr_cuda`` K6, ``tcsr_cuda`` K7
    and/or K6, ``rsell_cuda`` K4, ``asp_cuda`` K9, and ``ell_torch`` none;
    then K6 on ``bsr_cuda``'s pack (block_m 512), K7 on ``tcsr_cuda``'s
    (its SELL tier), K4 on ``rsell_cuda``'s and K9 on ``asp_cuda``'s (its
    full plan), where 48 of their 49 counted launches land, against their
    plain versions and the oracle at B = 1 and 8, timed beside cuBLAS and
    K2 on the same dense A (K6, K9) and cuSPARSE and K1 on its SELL pack
    (K7, K4): the ``by_workload`` of their rows (K6, K7 and K4 walk the
    pack as work items, sized to fill the card, and a second kernel sums
    each group's items in a fixed order; K9 is one launch, a cluster of
    blocks a column strip summing its slices in distributed shared
    memory); K4 and K9 must give the same bits on two calls, and K9 must
    agree through a static, a device and an explicit plan and give 0 on
    an all-zero X;
14. holds K12 at B = 1 and 8 against its plain version and the oracle,
    timed beside its plain version and cuSPARSE CSR (one launch a call: a
    column's bitmap decoded once into a list of its live positions, then
    only live values multiplied, for every batch row); a small BELL at
    block_m 128 and 256; ``BinnedSellMatrix`` built on the skew matrix
    (K1 once per bucket and K5 once a call on the buckets' outputs in
    place, against the oracle); and
    ``auto_format`` on the router test's skewed 65536^2 CSR at B = 48,
    which must now pack ``BinnedSellMatrix``;
15. the floors study (``tpusparse_torch.bench.report``: 4096^2, d in
    {0.1, 0.5}, B in {1, 8, 32}): K11 against its plain version and the
    oracle at every point, on a pad-collision matrix (row 0 all ones) at
    B = 1, 32 and 40 (two batch tiles), and on a CSR with repeated entries
    (the kernel's fallback from stores to adds), K1's ring kernel against
    its plain version and the oracle at B = 32 and 40, then K11, K1, cuBLAS and
    cuSPARSE timed at every point beside K11's tensor-core floor, K11's
    and K1's launches counted over the timed study alone. K11 is one
    launch a call:
    bulk-copied tiles, a store scatter into shared memory, 3xTF32
    ``mma.sync`` on the tensor cores and the fused split-K sum.

Kernel against plain version: atol 1e-4 (the same products summed in
another order); against the float64 oracle: atol 1e-3 (the repo's
contract). It prints each kernel's launches summed over the counted runs
of all the paths above (also ``launches_all_paths`` in its row), one
``{"kernels": [...]}`` line (K3's row with its live-1/4 points, the sweep
and the plan kernel; K5's with its launches on binned SELL's path and the
fused unpermute's cost and count), the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failed check raises, so the
exit code is not 0 and no result line is printed. With no CUDA device it
exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tpusparse_torch import (AspMatrix, AwspMatrix, BellMatrix,
                             BinnedSellMatrix, BsrMatrix, CsrMatrix,
                             DiaMatrix, RsellMatrix, SellMatrix, SpmvConfig,
                             TcsrMatrix, auto_format, matrix_stats,
                             matrix_stats_csr, spmm, spmv, trainable_linear)
from tpusparse_torch.autodiff import retied
from tpusparse_torch.bench import report
from tpusparse_torch.bench.abba import SWEEP, awsp_bytes, sweep_matrix, x_pool
from tpusparse_torch.bench.roofline import (ARTIFACT_SHARE, card_info,
                                            detect_hbm_gbps, format_bytes,
                                            roofline_fraction)
from tpusparse_torch.bench.runner import device_time
from tpusparse_torch.bench.suite import registry
from tpusparse_torch.formats import tcsr as tcsr_mod
from tpusparse_torch.formats.auto import route
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.asp_spmv import asp_spmm, asp_spmm_plain
from tpusparse_torch.kernels.awsp_spmv import (awsp_spmm, awsp_spmm_plain,
                                               device_group_plan,
                                               device_group_plan_plain)
from tpusparse_torch.kernels.bell_spmv import bell_spmm, bell_spmm_plain
from tpusparse_torch.kernels.bsell_spmv import bsell_spmm, bsell_spmm_plain
from tpusparse_torch.kernels.bsr_spmv import bsr_spmm, bsr_spmm_plain
from tpusparse_torch.kernels.dense import dense_cuda, dense_plain, dense_torch
from tpusparse_torch.kernels.dia_spmv import dia_spmv, dia_spmv_plain
from tpusparse_torch.kernels.permute import (permute_columns,
                                             permute_columns_plain)
from tpusparse_torch.kernels.rsell_spmv import rsell_spmm, rsell_spmm_plain
from tpusparse_torch.kernels.sell_grad import sell_dvals, sell_dvals_plain
from tpusparse_torch.kernels.sell_mxu_spmm import (sell_mxu_spmm,
                                                   sell_mxu_spmm_plain)
from tpusparse_torch.kernels.sell_spmv import sell_spmm, sell_spmm_plain
from tpusparse_torch.nn import SparseLinear
from tpusparse_torch.testing import generators, reference
from tpusparse_torch.testing.tester import KernelEntry, SpmvTester

ATOL = 1e-3            # the repo's contract against the float64 oracle
PLAIN_ATOL = 1e-4      # kernel against its plain version; bf16/int8 lanes
FP32_TFLOPS = 67.0     # H100 SXM fp32 peak outside the tensor cores
BATCHES = (1, 8)
WRAPPERS = {"sell_spmv": sell_spmm, "dense": dense_cuda,
            "awsp_spmv": awsp_spmm}
SKEW_WRAPPERS = {"rsell_spmv": rsell_spmm, "permute": permute_columns,
                 "asp_spmv": asp_spmm}
# the router's skew workload (tpusparse/formats/auto.py, BENCH.md's 8192^2
# powerlaw row) and the batch at which each kernel runs on its path
SKEW = dict(m=8192, n=8192, density=0.15, distribution="powerlaw", seed=0)
SKEW_BATCH = {"rsell_spmv": 1, "permute": 1, "asp_spmv": 8}
BLOCK_WRAPPERS = {"bsell_spmv": bsell_spmm, "bsr_spmv": bsr_spmm}
BANDED_WRAPPERS = {"dia_spmv": dia_spmv}
TRAIN_WRAPPERS = {"sell_spmv": sell_spmm, "sell_grad": sell_dvals}
ALL_WRAPPERS = {**WRAPPERS, **SKEW_WRAPPERS, **BLOCK_WRAPPERS,
                **BANDED_WRAPPERS, **TRAIN_WRAPPERS, "bell_spmv": bell_spmm,
                "sell_mxu_spmm": sell_mxu_spmm,
                "group_plan": device_group_plan}   # K3's and K9's device plan
# the kernels each full-registry entry must launch (tcsr_cuda: K7 and/or
# K6, whichever tiers its pack holds)
FULL_KERNELS = {"ell_torch": (), "bell_cuda": ("bell_spmv",),
                "sell_binned_cuda": ("sell_spmv", "permute"),
                "bsr_cuda": ("bsr_spmv",),
                "tcsr_cuda": ("bsell_spmv", "bsr_spmv"),
                "rsell_cuda": ("rsell_spmv",), "asp_cuda": ("asp_spmv",)}
# the floors point whose K11 time heads its row (the largest batch, where
# the decompress-to-dense design is meant to pay)
FLOORS_HEAD = (0.5, 32)
# the gallery's blockpruned-4096 (tpusparse/bench/gallery.py) and the 1M-
# unknown Laplacian (BENCH.md §Solver), and the batch each kernel's path runs
BLOCKY = dict(m=4096, n=4096, block=128, keep_frac=0.3, fill=0.5, seed=9)
STENCIL = (1024, 1024)
PATH_BATCH = {**SKEW_BATCH, "bsell_spmv": 1, "bsr_spmv": 8, "dia_spmv": 1,
              "sell_grad": 8}
# the training run: example 08's head width, its steps and learning rate;
# X is scaled so that the hidden pre-activations have about unit variance
# (4096 * 0.5 (A's density) * E[x^2] = 1/6 * E[a^2] = 1/3, about 114)
HEAD, STEPS, LR, X_SCALE = 64, 5, 0.02, 114.0 ** -0.5
META = {
    "sell_spmv": ("tpusparse_torch/csrc/sell_spmv.cu",
                  "tpusparse/kernels/sell_spmv.py:115"),
    "dense": ("tpusparse_torch/csrc/dense.cu",
              "tpusparse/kernels/dense.py:90"),
    "awsp_spmv": ("tpusparse_torch/csrc/awsp_spmv.cu",
                  "tpusparse/kernels/awsp_spmv.py:121"),
    "rsell_spmv": ("tpusparse_torch/csrc/rsell_spmv.cu",
                   "tpusparse/kernels/rsell_spmv.py:212"),
    "permute": ("tpusparse_torch/csrc/permute.cu",
                "tpusparse/kernels/permute.py:86"),
    "asp_spmv": ("tpusparse_torch/csrc/asp_spmv.cu",
                 "tpusparse/kernels/asp_spmv.py:69"),
    "bsr_spmv": ("tpusparse_torch/csrc/bsr_spmv.cu",
                 "tpusparse/kernels/bsr_spmv.py:144"),
    "bsell_spmv": ("tpusparse_torch/csrc/bsell_spmv.cu",
                   "tpusparse/kernels/bsell_spmv.py:140"),
    "dia_spmv": ("tpusparse_torch/csrc/dia_spmv.cu",
                 "tpusparse/kernels/dia_spmv.py:184"),
    "sell_grad": ("tpusparse_torch/csrc/sell_grad.cu",
                  "tpusparse/kernels/sell_grad.py:92"),
    "bell_spmv": ("tpusparse_torch/csrc/bell_spmv.cu",
                  "tpusparse/kernels/bell_spmv.py:137"),
    "sell_mxu_spmm": ("tpusparse_torch/csrc/sell_mxu_spmm.cu",
                      "tpusparse/kernels/sell_mxu_spmm.py:98"),
}


class SmokeFailure(AssertionError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def max_err(y: torch.Tensor, ref) -> float:
    ref = torch.as_tensor(ref, device=y.device).double()
    return float((y.double() - ref).abs().max())


def build_kernels() -> None:
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"built {so.relative_to(_build.BUILD_DIR.parent.parent)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in (so.parent / "build.log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())


def main_path() -> dict[str, int]:
    """The headline registry through the public API, counted."""
    for w in WRAPPERS.values():
        w.launches = 0
    for batch in BATCHES:
        tester = SpmvTester(SpmvConfig(batch=batch), device="cuda")
        for e in registry():
            tester.register(KernelEntry(e["name"], e["prepare"], e["run"]))
        print(f"-- headline path, B={batch}")
        for rep in tester.run(time_it=True):    # raises on any mismatch
            t = rep.timing
            share = roofline_fraction(t.bytes_moved, t.seconds)
            require(share <= ARTIFACT_SHARE,
                    f"{rep.name}: roofline share {share:.3f} is an artifact")
            print(f"   {rep.name}: {t.seconds * 1e6:.2f} us, "
                  f"{t.nnz_per_s / 1e9:.3f} Gnnz/s, roofline {share:.3f}")
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    tally(launches)
    print("launches on the headline path:", json.dumps(launches))
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch on the headline path")
    return launches


def kernel_cases(a, dev):
    """For each headline kernel: a function of (x (B, m) on the card, the
    oracle y (B, n)) giving (kernel, plain, library) callables, the bytes
    and flops of one call, and the oracle of the kernel's own output."""
    m, n = a.shape
    nnz = int((a != 0).sum())
    a_dev = torch.from_numpy(a).to(dev)
    at_csr = torch.from_numpy(np.ascontiguousarray(a.T)).to(dev) \
        .to_sparse_csr()
    sell = SellMatrix.from_dense(a, device=dev)
    awsp = AwspMatrix.from_dense(a, g=8, device=dev)
    plan, k = awsp._full_plan(), awsp._count(awsp.n_groups)

    def sell_case(xt, y_ref):
        args = (sell.idx, sell.vals, xt)
        nbytes = sell.device_bytes() + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: sell_spmm(*args, n=n),
                lambda: sell_spmm_plain(*args, n=n), cusparse(at_csr, xt),
                nbytes, 2 * nnz * xt.shape[0], y_ref)

    def dense_case(xt, y_ref):
        nbytes = 4 * (m * n + xt.numel() + xt.shape[0] * n)
        return (lambda: dense_cuda(a_dev, xt), lambda: dense_plain(a_dev, xt),
                lambda: dense_torch(a_dev, xt), nbytes,
                2 * m * n * xt.shape[0], y_ref)

    def awsp_case(xt, y_ref):
        args = (plan, k, awsp.idx, awsp.vals, xt)
        nbytes = awsp.device_bytes() + 4 * (xt.numel() + xt.shape[0] * n
                                            + plan.numel() + 1)
        return (lambda: awsp_spmm(*args, g=awsp.g, n=n),
                lambda: awsp_spmm_plain(*args, g=awsp.g, n=n),
                cusparse(at_csr, xt), nbytes, 2 * nnz * xt.shape[0], y_ref)

    return {"sell_spmv": sell_case, "dense": dense_case,
            "awsp_spmv": awsp_case}


def cusparse(at_csr, xt):
    """cuSPARSE CSR of A.T times x: the library yardstick of K1, K3, K4."""
    return (lambda: at_csr @ xt[0]) if xt.shape[0] == 1 else \
        (lambda: at_csr @ xt.T)


def skew_kernel_cases(a, r: RsellMatrix, asp: AspMatrix, dev):
    """The same, for the skew path's kernels: K4 on the RSELL pack (its
    output is in the pack's sorted column order), K5 on the oracle in that
    order, K9 on the ASP matrix with this X's host plan."""
    m, n = a.shape
    nnz = int((a != 0).sum())
    np_ = r.padded[1]
    at_csr = torch.from_numpy(np.ascontiguousarray(a.T)).to(dev) \
        .to_sparse_csr()
    a_dev = torch.from_numpy(a).to(dev)
    src = r.perm_src
    src_long = src.long()
    inv_perm = r.inv_perm

    def sorted_order(y_ref):
        ys = np.zeros((y_ref.shape[0], np_), np.float32)
        ys[:, inv_perm[:n]] = y_ref
        return ys

    def rsell_case(xt, y_ref):
        args = (r.cj, r.ct, r.idx, r.vals, xt)
        nbytes = r.device_bytes() + 4 * (xt.numel() + xt.shape[0] * np_)
        return (lambda: rsell_spmm(*args, n_padded=np_, plan=r._work),
                lambda: rsell_spmm_plain(*args, n_padded=np_),
                cusparse(at_csr, xt), nbytes, 2 * nnz * xt.shape[0],
                sorted_order(y_ref))

    def permute_case(xt, y_ref):
        ys = torch.from_numpy(sorted_order(y_ref)).to(dev)
        nbytes = 4 * (ys.numel() + src.numel() + ys.shape[0] * n)
        return (lambda: permute_columns(ys, src),
                lambda: permute_columns_plain(ys, src),
                lambda: torch.index_select(ys, 1, src_long), nbytes, 0,
                y_ref)

    def asp_case(xt, y_ref):
        plan = torch.from_numpy(asp.plan(xt.cpu().numpy())).to(dev)
        k = asp._count(plan.numel())
        live = plan.numel()                 # windows this X needs
        nbytes = 4 * (live * 128 * n + xt.numel() + xt.shape[0] * n
                      + plan.numel() + 1)
        return (lambda: asp_spmm(plan, k, asp.a_pad, xt, n=n),
                lambda: asp_spmm_plain(plan, k, asp.a_pad, xt, n=n),
                lambda: dense_torch(a_dev, xt), nbytes,
                2 * live * 128 * n * xt.shape[0], y_ref)

    return {"rsell_spmv": rsell_case, "permute": permute_case,
            "asp_spmv": asp_case}


def check_kernels(cases, oracle, xs, dev) -> dict[str, dict]:
    """Kernel vs plain version vs oracle (``oracle(x) -> y`` in float64,
    cast to fp32), and the three timings."""
    hbm = detect_hbm_gbps() * 1e9
    out = {name: {"by_batch": {}} for name in cases}
    for batch, x in zip(BATCHES, xs):
        xt = torch.from_numpy(x).to(dev)
        y_ref = oracle(x)
        for name, case in cases.items():
            kern, plain, lib, nbytes, flops, want = case(xt, y_ref)
            yk = kern()
            yp = plain()
            torch.cuda.synchronize()
            e_plain, e_ref = max_err(yk, yp), max_err(yk, want)
            require(e_plain <= PLAIN_ATOL and e_ref <= ATOL,
                    f"{name} B={batch}: |kernel-plain| {e_plain:.3e} > "
                    f"{PLAIN_ATOL} or |kernel-oracle| {e_ref:.3e} > {ATOL}")
            ms = device_time(kern, name=name).seconds * 1e3
            plain_ms = device_time(plain, name=name, warmup=1,
                                   reps=5).seconds * 1e3
            lib_ms = device_time(lib, name=name).seconds * 1e3
            t_bytes, t_ops = nbytes / hbm * 1e3, flops / (FP32_TFLOPS * 1e12) * 1e3
            bound = max(t_bytes, t_ops)
            share = bound / ms
            require(share <= ARTIFACT_SHARE,
                    f"{name} B={batch}: roofline share {share:.3f} is an "
                    f"artifact")
            row = {"max_abs_err": e_plain, "max_abs_err_oracle": e_ref,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "share": share}
            out[name]["by_batch"][batch] = row
            print(f"{name} B={batch}: max|k-plain|={e_plain:.3e} "
                  f"max|k-oracle|={e_ref:.3e} | {ms * 1e3:.2f} us, bound "
                  f"{bound * 1e3:.2f} us ({row['bound_by']}, "
                  f"{nbytes / 1e6:.2f} MB), share {share:.3f} | plain "
                  f"{plain_ms * 1e3:.2f} us | library {lib_ms * 1e3:.2f} us")
    return out


def check_device_plan(a, x1, dev) -> None:
    """AWSP device plan on a structured X, with host syncs made errors."""
    m = a.shape[0]
    f = AwspMatrix.from_dense(a, g=1, device=dev)
    live = (np.arange(m) // 128) % 4 == 0          # a quarter of the windows
    xs = np.where(live, x1, 0.0).astype(np.float32)
    xb = np.stack([xs, np.roll(xs, 1)]).astype(np.float32)
    xb[:, ~live] = 0.0
    xs_t, xb_t = torch.from_numpy(xs).to(dev), torch.from_numpy(xb).to(dev)
    zero = torch.zeros_like(xs_t)
    torch.cuda.synchronize()
    before = awsp_spmm.launches, device_group_plan.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        y_dev = spmv(f, xs_t)                    # CUDA tensor -> device plan
        yb_dev = f.spmm(xb_t)
        y_zero = spmv(f, zero)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require((awsp_spmm.launches, device_group_plan.launches)
            == (before[0] + 3, before[1] + 3),
            "device plan: a plan kernel and a K3 launch a call expected")
    y_static = spmv(f, xs)                       # host data -> host plan
    require(len(f.plan(xs)) == f.n_groups // 4,
            f"host plan has {len(f.plan(xs))} groups, want {f.n_groups // 4}")
    e_static = max_err(y_dev, y_static)
    e_ref = max(max_err(y_dev, reference.sgemv_cpu(xs, a)),
                max_err(yb_dev, reference.sgemm_cpu(xb, a)))
    zero_ok = int(torch.count_nonzero(y_zero)) == 0
    print(f"awsp device plan (1/4 windows live, g=1, sync debug 'error'): "
          f"|device-static|={e_static:.3e} |device-oracle|={e_ref:.3e} "
          f"all-zero X -> zero: {zero_ok}")
    require(e_static <= PLAIN_ATOL and e_ref <= ATOL and zero_ok,
            "awsp device plan disagrees")


def check_awsp_sweep(dev) -> dict:
    """Phase 3b: K3 on the JAX package's live-fraction sweep (4096^2,
    d = 0.5, g = 2: live 1/16, 1/4, 1/2 and 1, B = 1 and 8, the pattern
    shared by the batch): the public call on a CUDA X (the plan kernel,
    then K3) and K3 with the exact host plan, each against the plain
    version and the oracle, timed beside its bound; the plan kernel against
    ``device_group_plan_plain`` bit for bit there and at live 0, timed at
    B = 8, its launches counted over this phase."""
    a_l = sweep_matrix()
    f = AwspMatrix.from_dense(a_l, g=SWEEP["g"], device=dev)
    ng, span = f.n_groups, f.span
    hbm = detect_hbm_gbps() * 1e9
    m = SWEEP["m"]
    print(f"-- K3 on the live-fraction sweep: {f!r}")
    points = [(live, b) for live in (0.0,) + SWEEP["lives"] for b in BATCHES]
    xs = {p: (x_pool(m, ng, span, *p) if p[0] else
              np.zeros((p[1], m), np.float32)) for p in points}
    xts = {p: torch.from_numpy(x).to(dev) for p, x in xs.items()}
    torch.cuda.synchronize()
    zero_counts()
    ys = {p: f.spmm(xt) for p, xt in xts.items()}   # plan kernel, then K3
    torch.cuda.synchronize()
    launches = read_counts(("awsp_spmv", "group_plan"))
    tally(launches)
    print("launches on the sweep:", json.dumps(launches))
    require(launches == {"awsp_spmv": len(points), "group_plan": len(points)},
            "K3 sweep: a plan kernel and a K3 launch a call expected")
    rows = {}
    for (live, b), x in xs.items():
        xt, y_dev = xts[live, b], ys[live, b]
        plan, k = device_group_plan(xt, ng, span)
        want_plan, want_k = device_group_plan_plain(xt, ng, span)
        torch.cuda.synchronize()
        require(torch.equal(plan, want_plan) and torch.equal(k, want_k),
                f"plan kernel live={live} B={b}: not the plain plan")
        hp = torch.from_numpy(f.plan(x)).to(dev)
        hk = f._count(hp.numel())
        args = (hp, hk, f.idx, f.vals, xt)
        y_host = awsp_spmm(*args, g=f.g, n=f.shape[1])
        y_plain = awsp_spmm_plain(*args, g=f.g, n=f.shape[1])
        y_ref = reference.sgemm_cpu(x, a_l)
        e_plain = max(max_err(y_host, y_plain), max_err(y_dev, y_plain))
        e_ref = max(max_err(y_host, y_ref), max_err(y_dev, y_ref))
        require(e_plain <= PLAIN_ATOL and e_ref <= ATOL,
                f"K3 live={live} B={b}: |k-plain| {e_plain:.3e}, "
                f"|k-oracle| {e_ref:.3e}")
        if not live:
            require(int(torch.count_nonzero(y_dev)) == 0,
                    "K3: an all-zero X gave y != 0")
            continue
        nbytes = awsp_bytes(f, hp.numel(), b, hp.numel())
        ms = device_time(lambda: awsp_spmm(*args, g=f.g, n=f.shape[1]),
                         name="awsp_spmv").seconds * 1e3
        dev_ms = device_time(lambda: f.spmm(xt)).seconds * 1e3
        bound = nbytes / hbm * 1e3
        require(bound / ms <= ARTIFACT_SHARE,
                f"K3 live={live} B={b}: share {bound / ms:.3f}")
        rows[f"live={live},B={b}"] = {
            "ms": ms, "device_plan_call_ms": dev_ms, "bound_ms": bound,
            "bound_by": "bytes", "bytes": nbytes, "share": bound / ms,
            "max_abs_err": e_plain, "max_abs_err_oracle": e_ref}
        print(f"   live={live} B={b}: {hp.numel()} of {ng} groups, "
              f"|k-plain|={e_plain:.3e} |k-oracle|={e_ref:.3e} | K3 "
              f"(host plan) {ms * 1e3:.2f} us, bound {bound * 1e3:.2f} "
              f"us, share {bound / ms:.3f} | public call (plan kernel + "
              f"K3) {dev_ms * 1e3:.2f} us")
    x = x_pool(m, ng, span, 0.25, 8)
    xt = torch.from_numpy(x).to(dev)
    plan_ms = device_time(lambda: device_group_plan(xt, ng, span)).seconds * 1e3
    plain_ms = device_time(lambda: device_group_plan_plain(xt, ng, span),
                           warmup=1, reps=5).seconds * 1e3
    nbytes = 4 * (x.size + ng + 1)
    plan_row = {"name": "group_plan", "launches": launches["group_plan"],
                "source": "tpusparse_torch/csrc/group_plan.cu",
                "max_abs_err": 0.0, "ms": plan_ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
                "library_ms": None, "point": "live=0.25,B=8"}
    print(f"   plan kernel (live 1/4, B=8): {plan_ms * 1e3:.2f} us, bound "
          f"{plan_row['bound_ms'] * 1e3:.3f} us | plain (torch ops) "
          f"{plain_ms * 1e3:.2f} us")
    return {"by_point": rows, "device_plan": plan_row}


def fused_unpermute_cost(r: RsellMatrix, x1, x8, dev) -> dict:
    """The sorted skew pack's public call (K4, its second kernel writing the
    user's column order) against K4 alone in the pack's order, B = 1 and
    8, timed in turns (call, K4, K4, call): what the unpermute costs now
    that it rides K4."""
    out = {}
    for batch, x in zip(BATCHES, (x1[None, :], x8)):
        xt = torch.from_numpy(x).to(dev)
        calls = (lambda: r.spmm(xt),
                 lambda: rsell_spmm(r.cj, r.ct, r.idx, r.vals, xt,
                                    n_padded=r.padded[1], plan=r._work))
        t = [device_time(calls[i]).seconds * 1e3 for i in (0, 1, 1, 0)]
        call_ms, k4_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        out[str(batch)] = {"rsell_call_ms": call_ms, "k4_pack_order_ms": k4_ms,
                           "cost_ms": call_ms - k4_ms}
        print(f"   fused unpermute B={batch}: RSELL call {call_ms * 1e3:.2f} "
              f"us, K4 in pack order {k4_ms * 1e3:.2f} us, cost "
              f"{(call_ms - k4_ms) * 1e3:+.2f} us")
    return out


def check_lanes(a, x8, dev) -> None:
    """K1's bf16 and int8 storage lanes against their plain versions."""
    xt = torch.from_numpy(x8).to(dev)
    for lane in (torch.bfloat16, "int8"):
        f = SellMatrix.from_dense(a, dtype=lane, device=dev)
        yk = sell_spmm(f.idx, f.vals, xt, scales=f.scales, n=f.shape[1])
        yp = sell_spmm_plain(f.idx, f.vals, xt, scales=f.scales, n=f.shape[1])
        err = max_err(yk, yp)
        ms = device_time(lambda: sell_spmm(f.idx, f.vals, xt, scales=f.scales,
                                           n=f.shape[1])).seconds * 1e3
        print(f"sell_spmv lane {lane} B=8: max|k-plain|={err:.3e} "
              f"(|k-oracle|={max_err(yk, reference.sgemm_cpu(x8, a)):.3e}, "
              f"outside the contract), {ms * 1e3:.2f} us, "
              f"{f.device_bytes() / 1e6:.1f} MB")
        require(err <= PLAIN_ATOL,
                f"sell lane {lane}: {err:.3e} > {PLAIN_ATOL}")


def skew_path(a, x1, x8, dev) -> tuple[RsellMatrix, AspMatrix, dict]:
    """The router's skew path through the public API, counted."""
    m, n = a.shape
    t0 = time.perf_counter()
    stats = matrix_stats(a)
    routes = {b: route(m, n, stats, expect_batch=b) for b in BATCHES}
    print(f"-- skew path: {m}x{n} {SKEW['distribution']} d={SKEW['density']}"
          f", nnz {stats['nnz']}, w_global {stats['w_global']}, w_typical "
          f"{stats['w_typical']}; route B=1 -> {routes[1]!r}, B=8 -> "
          f"{routes[8]!r}")
    require(routes == {1: "rsell", 8: "asp"}, f"routes {routes}")
    r = auto_format(a, expect_batch=1, stats=stats)       # device=None: GPU
    asp = auto_format(a, expect_batch=8, stats=stats)
    require(isinstance(r, RsellMatrix) and isinstance(asp, AspMatrix),
            f"auto_format gave {type(r).__name__}, {type(asp).__name__}")
    require(r.perm_src is not None and r.run == 8,
            "the skew pack should be sorted and run-aligned")
    print(f"   {r!r}\n   {asp!r}\n   stats + packs + upload "
          f"{time.perf_counter() - t0:.1f} s")
    x1t, x8t = torch.from_numpy(x1).to(dev), torch.from_numpy(x8).to(dev)
    torch.cuda.synchronize()
    for w in SKEW_WRAPPERS.values():
        w.launches = 0
    fused = rsell_spmm.unpermutes
    y1 = spmv(r, x1t)
    y8 = spmm(asp, x8t)                # CUDA tensor -> ASP device plan
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in SKEW_WRAPPERS.items()}
    fused = rsell_spmm.unpermutes - fused
    FUSED_UNPERMUTES[0] += fused
    tally(launches)
    print("launches on the skew path:", json.dumps(launches),
          f"(K4 unpermuted in its second kernel: {fused})")
    for name in ("rsell_spmv", "asp_spmv"):
        require(launches[name] > 0, f"{name}: no launch on the skew path")
    require(launches["permute"] == 0 and fused == launches["rsell_spmv"],
            "skew path: the sorted pack's unpermute should ride K4, with no "
            "K5 launch")
    e1 = max_err(y1, reference.sgemv_cpu(x1, a))
    e8 = max_err(y8, reference.sgemm_cpu(x8, a))
    print(f"   spmv(rsell) |y-oracle|={e1:.3e}, spmm(asp, B=8) "
          f"|y-oracle|={e8:.3e}")
    require(y1.shape == (n,) and y8.shape == (8, n) and e1 <= ATOL
            and e8 <= ATOL, "skew path disagrees with the oracle")
    return r, asp, launches


def check_asp_device_plan(asp: AspMatrix, a, x8, dev) -> None:
    """ASP device plan on a structured X, with host syncs made errors."""
    m = a.shape[0]
    live = (np.arange(m) // 128) % 4 == 0          # a quarter of the windows
    xs = np.where(live, x8, 0.0).astype(np.float32)
    xs_t = torch.from_numpy(xs).to(dev)
    zero = torch.zeros_like(xs_t)
    torch.cuda.synchronize()
    before = asp_spmm.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        y1_dev = spmv(asp, xs_t[0])              # CUDA tensor -> device plan
        y8_dev = spmm(asp, xs_t)
        y_zero = spmm(asp, zero)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(asp_spmm.launches == before + 3, "asp device plan: no launches")
    require(len(asp.plan(xs)) == asp.n_units // 4,
            f"host plan has {len(asp.plan(xs))} windows")
    e_static = max(max_err(y1_dev, spmv(asp, xs[0])),
                   max_err(y8_dev, spmm(asp, xs)))   # host data: host plan
    e_ref = max(max_err(y1_dev, reference.sgemv_cpu(xs[0], a)),
                max_err(y8_dev, reference.sgemm_cpu(xs, a)))
    zero_ok = int(torch.count_nonzero(y_zero)) == 0
    print(f"asp device plan (1/4 windows live, B=1 and 8, sync debug "
          f"'error'): |device-static|={e_static:.3e} "
          f"|device-oracle|={e_ref:.3e} all-zero X -> zero: {zero_ok}")
    require(e_static <= PLAIN_ATOL and e_ref <= ATOL and zero_ok,
            "asp device plan disagrees")


def check_rsell_bodies(dev) -> None:
    """K4 on a flat (run = 1) pack and on an unsorted pack, which needs no
    unpermute: each against its plain version and the oracle; the sorted
    flat pack's public call is K4 alone, its second kernel unpermuting, and
    equals the pack-order product unpermuted by K5 bit for bit."""
    packs = {"flat": (256, 2048, 0.01, 6), "unsorted": (1536, 2048, 0.25, 5)}
    for what, (m, n, d, seed) in packs.items():
        a = generators.random_sparse_matrix(m, n, density=d, seed=seed)
        r = RsellMatrix.from_dense(a, device=dev)
        ok = r.run == 1 if what == "flat" else r.perm_src is None
        require(ok, f"rsell {what}: run={r.run}, sorted="
                    f"{r.perm_src is not None}")
        for batch in BATCHES:
            x = generators.random_sparse_batch(batch, m, 0.5, seed)
            xt = torch.from_numpy(x).to(dev)
            args = (r.cj, r.ct, r.idx, r.vals, xt)
            yk = rsell_spmm(*args, n_padded=r.padded[1], plan=r._work)
            e_plain = max_err(yk, rsell_spmm_plain(*args,
                                                   n_padded=r.padded[1]))
            before = permute_columns.launches
            fused = rsell_spmm.unpermutes
            y = r.spmm(xt)
            e_ref = max_err(y, reference.sgemm_cpu(x, a))
            permuted = permute_columns.launches - before
            fused = rsell_spmm.unpermutes - fused
            FUSED_UNPERMUTES[0] += fused
            print(f"rsell {what} (run={r.run}, {len(r.cj)} chunks) "
                  f"B={batch}: max|k-plain|={e_plain:.3e} "
                  f"max|y-oracle|={e_ref:.3e}, K5 launches {permuted}, "
                  f"unpermuted by K4 {fused}")
            require(e_plain <= PLAIN_ATOL and e_ref <= ATOL,
                    f"rsell {what} B={batch} disagrees")
            require(permuted == 0 and fused == (r.perm_src is not None),
                    f"rsell {what}: {permuted} K5 launches, {fused} fused")
            if r.perm_src is not None:     # the same bits as K4, then K5
                want = permute_columns(yk, r.perm_src)
                torch.cuda.synchronize()
                require(torch.equal(y, want),
                        f"rsell {what} B={batch}: the fused unpermute is not "
                        f"K5's bits")


# each kernel's launches summed over the counted runs of every path, and the
# sorted-RSELL calls whose unpermute K4's second kernel did in those runs
TOTALS = dict.fromkeys(ALL_WRAPPERS, 0)
FUSED_UNPERMUTES = [0]


def tally(counts: dict[str, int]) -> None:
    for name, k in counts.items():
        TOTALS[name] += k


def zero_counts() -> None:
    for w in ALL_WRAPPERS.values():
        w.launches = 0


def read_counts(names) -> dict[str, int]:
    return {name: ALL_WRAPPERS[name].launches for name in names}


def block_path(a, x1, x8, dev) -> tuple[TcsrMatrix, TcsrMatrix, dict]:
    """The router's block-structured path through the public API,
    counted."""
    m, n = a.shape
    t0 = time.perf_counter()
    stats = matrix_stats(a)
    routes = {b: route(m, n, stats, expect_batch=b) for b in BATCHES}
    print(f"-- block-structured path: blockpruned-{m}, nnz {stats['nnz']}, "
          f"empty tiles {stats['empty_block_frac']:.3f}; route B=1 -> "
          f"{routes[1]!r}, B=8 -> {routes[8]!r}")
    require(routes == {1: "tcsr", 8: "tcsr"}, f"routes {routes}")
    f1 = auto_format(a, expect_batch=1, stats=stats)      # device=None: GPU
    f8 = auto_format(a, expect_batch=8, stats=stats)
    require(isinstance(f1, TcsrMatrix) and isinstance(f8, TcsrMatrix),
            f"auto_format gave {type(f1).__name__}, {type(f8).__name__}")
    for b, f in ((1, f1), (8, f8)):
        print(f"   B={b}: n_sell {f.n_sell}, n_dense {f.n_dense}, w {f.w}, "
              f"SELL tiles stored {f.vals.shape[0]}, dense blocks stored "
              f"{0 if f.bsr is None else f.bsr.blocks.shape[0]}, "
              f"{f.device_bytes() / 1e6:.2f} MB")
    require(f1.n_dense == 0 and f1.n_sell > 0 and f8.n_sell == 0
            and f8.n_dense > 0, "tcsr tiers: expected SELL only at B = 1, "
            "dense only at B = 8")
    print(f"   stats + packs + upload {time.perf_counter() - t0:.1f} s")
    x1t, x8t = torch.from_numpy(x1).to(dev), torch.from_numpy(x8).to(dev)
    torch.cuda.synchronize()
    zero_counts()
    y1 = spmv(f1, x1t)
    y8 = spmm(f8, x8t)
    torch.cuda.synchronize()
    launches = read_counts(BLOCK_WRAPPERS)
    tally(launches)
    print("launches on the block-structured path:", json.dumps(launches))
    for name, k in launches.items():
        require(k > 0, f"{name}: no launch on the block-structured path")
    e1 = max_err(y1, reference.sgemv_cpu(x1, a))
    e8 = max_err(y8, reference.sgemm_cpu(x8, a))
    print(f"   spmv(tcsr, B=1) |y-oracle|={e1:.3e}, spmm(tcsr, B=8) "
          f"|y-oracle|={e8:.3e}")
    require(y1.shape == (n,) and y8.shape == (8, n) and e1 <= ATOL
            and e8 <= ATOL, "block-structured path disagrees with the oracle")
    return f1, f8, launches


def csr_oracle(csr):
    """float64 Y = X @ A from the CSR of A.T through scipy (A is never
    densified), cast to fp32."""
    at = csr.to_scipy().T.tocsr().astype(np.float64)

    def oracle(x):
        x = np.asarray(x, np.float64)
        y = at @ x.T if x.ndim == 2 else at @ x
        return np.ascontiguousarray(y.T if x.ndim == 2 else y, np.float32)
    return oracle


def torch_csr_of_at(csr, dev):
    """The CSR of A.T as a torch sparse CSR tensor on the card (cuSPARSE)."""
    m, n = csr.shape
    return torch.sparse_csr_tensor(
        torch.from_numpy(csr.row_ptr.astype(np.int64)),
        torch.from_numpy(csr.col_idx.astype(np.int64)),
        torch.from_numpy(np.asarray(csr.values, np.float32)),
        size=(n, m)).to(dev)


def banded_path(csr, x1, x8, dev) -> tuple[DiaMatrix, dict]:
    """The router's banded path through the public API, counted."""
    m, n = csr.shape
    t0 = time.perf_counter()
    stats = matrix_stats_csr(csr)
    kind = route(m, n, stats)
    print(f"-- banded path: {STENCIL[0]}x{STENCIL[1]} 5-point Laplacian, "
          f"n {n}, nnz {stats['nnz']}, diagonals {stats['n_diags']}, sym "
          f"{stats['diag_sym']}; route -> {kind!r}")
    d = auto_format(csr, stats=stats)                     # device=None: GPU
    require(isinstance(d, DiaMatrix) and d.sym
            and d.offsets == (0, 1, STENCIL[1]),
            f"auto_format gave {d!r}")
    print(f"   {d!r}, stats + pack + upload "
          f"{time.perf_counter() - t0:.1f} s")
    oracle = csr_oracle(csr)
    x1t, x8t = torch.from_numpy(x1).to(dev), torch.from_numpy(x8).to(dev)
    torch.cuda.synchronize()
    zero_counts()
    y1 = spmv(d, x1t)
    torch.cuda.synchronize()
    launches = read_counts(BANDED_WRAPPERS)
    tally(launches)
    y8 = spmm(d, x8t)                  # the shifted torch form, no kernel
    torch.cuda.synchronize()
    print("launches on the banded path:", json.dumps(launches))
    require(launches["dia_spmv"] > 0, "dia_spmv: no launch on the banded path")
    e1, e8 = max_err(y1, oracle(x1)), max_err(y8, oracle(x8))
    print(f"   spmv(dia) |y-oracle|={e1:.3e}, spmm(dia, B=8, shifted form) "
          f"|y-oracle|={e8:.3e}")
    require(y1.shape == (n,) and y8.shape == (8, n) and e1 <= ATOL
            and e8 <= ATOL, "banded path disagrees with the oracle")
    return d, launches


def block_kernel_cases(a, f1: TcsrMatrix, f8: TcsrMatrix, dev):
    """K7 on the B = 1 pack's SELL tier, K6 on the B = 8 pack's dense
    tier, each at both batches."""
    m, n = a.shape
    nnz = int((a != 0).sum())
    at_csr = torch.from_numpy(np.ascontiguousarray(a.T)).to(dev) \
        .to_sparse_csr()
    a_dev = torch.from_numpy(a).to(dev)
    b = f8.bsr

    def bsell_case(xt, y_ref):
        args = (f1.s_bi, f1.s_bj, f1.idx, f1.vals, xt)
        nbytes = f1.device_bytes() + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: bsell_spmm(*args, n_padded=f1.padded[1], n=n,
                                   plan=f1._work),
                lambda: bsell_spmm_plain(*args, n_padded=f1.padded[1], n=n),
                cusparse(at_csr, xt), nbytes, 2 * nnz * xt.shape[0], y_ref)

    def bsr_case(xt, y_ref):
        args = (b.bi, b.bj, b.blocks, xt)
        nbytes = b.device_bytes() + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: bsr_spmm(*args, n_padded=b.padded[1], n=n,
                                 plan=b._work),
                lambda: bsr_spmm_plain(*args, n_padded=b.padded[1], n=n),
                lambda: dense_torch(a_dev, xt), nbytes,
                2 * nnz * xt.shape[0], y_ref)

    return {"bsell_spmv": bsell_case, "bsr_spmv": bsr_case}


def banded_kernel_cases(csr, d: DiaMatrix, dev):
    """K8 on the Laplacian's DIA pack. The kernel takes one vector, so a
    batch of B is B launches (and B calls of the plain version)."""
    n = d.shape[1]
    at_csr = torch_csr_of_at(csr, dev)

    def rows(fn):
        return lambda xt: torch.stack([fn(d.offsets, d.vals, v, sym=d.sym,
                                          n=n) for v in xt])

    def dia_case(xt, y_ref):
        kern, plain = rows(dia_spmv), rows(dia_spmv_plain)
        nbytes = d.device_bytes() + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: kern(xt), lambda: plain(xt), cusparse(at_csr, xt),
                nbytes, 2 * csr.nnz * xt.shape[0], y_ref)

    return {"dia_spmv": dia_case}


def check_block_extras(a, x8, dev) -> None:
    """A mixed-tier TCSR pack (split charge 0) and a BSR pack with
    block_m = 40, each against its plain version and the oracle."""
    m, n = 512, 1024
    rng = np.random.default_rng(7)
    mixed = np.zeros((m, n), np.float32)
    for g in range(n // 128):        # two near-full and two sparse tiles
        for k, fill in ((0, 0.97), (1, 0.97), (2, 0.08), (3, 0.08)):
            bi = (g + k) % 4
            mixed[bi * 128:(bi + 1) * 128, g * 128:(g + 1) * 128] = \
                rng.uniform(0.1, 1, (128, 128)) * \
                (rng.random((128, 128)) < fill)
    saved = tcsr_mod._TIER_SPLIT_BYTES
    tcsr_mod._TIER_SPLIT_BYTES = 0
    try:
        f = TcsrMatrix.from_dense(mixed, device=dev)
    finally:
        tcsr_mod._TIER_SPLIT_BYTES = saved
    require(f.n_sell > 0 and f.n_dense > 0, f"mixed pack {f!r}")
    xm = generators.random_sparse_batch(8, m, 0.5, seed=7)
    before = (bsell_spmm.launches, bsr_spmm.launches)
    ym = f.spmm(torch.from_numpy(xm).to(dev))
    require((bsell_spmm.launches, bsr_spmm.launches) ==
            (before[0] + 1, before[1] + 1), "mixed pack: not K7 + K6")
    e_mixed = max_err(ym, reference.sgemm_cpu(xm, mixed))
    bsr = BsrMatrix.from_dense(a, block_m=40, device=dev)
    xt = torch.from_numpy(x8).to(dev)
    args = (bsr.bi, bsr.bj, bsr.blocks, xt)
    yb = bsr_spmm(*args, n_padded=bsr.padded[1], n=a.shape[1],
                  plan=bsr._work)
    e_plain = max_err(yb, bsr_spmm_plain(*args, n_padded=bsr.padded[1],
                                         n=a.shape[1]))
    e_bsr = max_err(yb, reference.sgemm_cpu(x8, a))
    print(f"tcsr mixed ({f.n_sell} SELL + {f.n_dense} dense tiles, w "
          f"{f.w}) B=8: |y-oracle|={e_mixed:.3e}; bsr block_m=40 "
          f"({bsr.n_real} blocks) B=8: |k-plain|={e_plain:.3e} "
          f"|y-oracle|={e_bsr:.3e}")
    require(e_mixed <= ATOL and e_plain <= PLAIN_ATOL and e_bsr <= ATOL,
            "mixed TCSR or block_m = 40 BSR disagrees")


def slots_to_dense(s, v, m, n):
    """float64 dense (m, n) from values ``v`` in the layout of the signed
    plane ``s``: slot (j, t, _, r) holds entry (t*128 + s, j*128 + r)."""
    live = s >= 0
    j, t, _, r = torch.nonzero(live, as_tuple=True)
    d = torch.zeros((s.shape[1] * 128, s.shape[0] * 128), dtype=torch.float64,
                    device=s.device)
    d[t * 128 + s[live].long(), j * 128 + r] = v[live].double()
    return d[:m, :n]


def training_path(csr, a, dev):
    """Phase 11, first half: trainable_linear's backward at B = 1 and 8,
    counted. Returns (apply, params, K10 launches)."""
    m, n = csr.shape
    t0 = time.perf_counter()
    apply, params, masks, _ = trainable_linear(csr)        # device=None: GPU
    torch.cuda.synchronize()
    st = apply.statics
    print(f"-- training path: trainable_linear({m}x{n}, nnz {csr.nnz}): "
          f"twin pack + upload {time.perf_counter() - t0:.1f} s; W "
          f"{st['s_f'].shape[2]} / {st['s_t'].shape[2]}, vals + vals_t "
          f"{2 * params['vals'].numel() * 4 / 1e6:.1f} MB")
    a64 = torch.from_numpy(a).to(dev).double()
    k10 = 0
    for batch in BATCHES:
        x = generators.random_sparse_batch(batch, m, 0.5, seed=batch)
        g = np.random.default_rng(batch).uniform(-1, 1, (batch, n)) \
            .astype(np.float32)
        if batch == 1:                             # a vector: spmv
            x, g = x[0], g[0]
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        gt = torch.from_numpy(g).to(dev)
        for p in params.values():
            p.grad = None
        torch.cuda.synchronize()
        zero_counts()
        apply(params, xt).backward(gt)
        torch.cuda.synchronize()
        counts = read_counts(TRAIN_WRAPPERS)
        tally(counts)
        print(f"   B={batch} backward launches: {json.dumps(counts)}")
        require(counts == {"sell_spmv": 2, "sell_grad": 2},
                f"B={batch}: K1 x2 and K10 x2 expected, got {counts}")
        k10 += counts["sell_grad"]
        x64 = xt.detach().double().reshape(-1, m)
        g64 = gt.double().reshape(-1, n)
        e_dx = max_err(xt.grad, (g64 @ a64.T).reshape(xt.shape))
        da = (x64.T @ g64) * (a64 != 0)                # mask(A) * (x.T g)
        e_v = float((slots_to_dense(st["s_f"], params["vals"].grad, m, n)
                     - da).abs().max())
        e_vt = float((slots_to_dense(st["s_t"], params["vals_t"].grad, n, m)
                      - da.T).abs().max())
        pads = sum(int(params[k].grad[~masks[k]].count_nonzero())
                   for k in params)
        print(f"   B={batch}: |dx-oracle|={e_dx:.3e} |dvals-oracle|="
              f"{e_v:.3e} |dvals_t-oracle|={e_vt:.3e}, nonzero pad "
              f"gradients {pads}")
        require(max(e_dx, e_v, e_vt) <= ATOL and pads == 0,
                f"B={batch}: gradients disagree with the oracle")
    return apply, params, k10


def training_run(csr, dev) -> int:
    """Phase 11, second half: example 08's MLP at full width, 5 SGD steps,
    counted. Returns K10 launches."""
    m, n = csr.shape
    torch.manual_seed(0)
    t0 = time.perf_counter()
    hidden = SparseLinear.from_csr(csr, use_bias=True,
                                   activation=torch.relu)   # on the GPU
    model = torch.nn.Sequential(hidden, torch.nn.Linear(n, HEAD).to(dev))
    print(f"   MLP {m} -> {n} (SparseLinear, bias, relu) -> {HEAD}: built "
          f"in {time.perf_counter() - t0:.1f} s")
    x = torch.from_numpy(generators.random_sparse_batch(
        8, m, 0.5, seed=11) * X_SCALE).to(dev)
    target = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (8, HEAD)).astype(np.float32) * 0.5).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    start = {k: v.detach().clone() for k, v in hidden.named_parameters()}
    losses, k10 = [], 0
    for _ in range(STEPS):
        opt.zero_grad()
        torch.cuda.synchronize()
        zero_counts()
        loss = ((model(x) - target) ** 2).mean()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss.backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = read_counts(TRAIN_WRAPPERS)
        tally(counts)
        require(counts == {"sell_spmv": 1, "sell_grad": 2},
                f"training step: K1 x1 and K10 x2 expected, got {counts}")
        k10 += counts["sell_grad"]
        opt.step()
        losses.append(float(loss.detach()))
    print(f"   losses {[f'{v:.6f}' for v in losses]}; each step K1 x1, "
          f"K10 x2; backward under sync debug 'error'")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"the loss did not fall: {losses}")
    moved = all(not torch.equal(v.detach(), start[k])
                for k, v in hidden.named_parameters())
    pads = sum(int(getattr(hidden, k).detach()[~hidden.masks[k]]
                   .count_nonzero()) for k in ("vals", "vals_t"))
    tied = retied(hidden.vals, hidden.t_gather, hidden.t_live)
    drift = float((hidden.vals_t.detach() - tied).abs().max())
    hidden.resync()
    print(f"   vals, vals_t and bias moved: {moved}; nonzero pads {pads}; "
          f"twin drift before resync {drift:.3e}")
    require(moved and pads == 0 and torch.equal(hidden.vals_t.detach(), tied),
            "training run: a copy did not move, a pad moved, or resync did "
            "not re-tie vals_t")
    return k10


def grad_kernel_cases(a, statics, dev):
    """K10 on the forward plane with this x and a fixed g per batch; the
    oracle is the float64 slot formula (``grad_oracle``)."""
    n = a.shape[1]
    s_f = statics["s_f"]
    nnz = int((a != 0).sum())
    a_csr = torch.from_numpy(a).to(dev).to_sparse_csr()   # A itself, (m, n)
    gs = {b: torch.from_numpy(np.random.default_rng(20 + b).uniform(
        -1, 1, (b, n)).astype(np.float32)).to(dev) for b in BATCHES}

    def grad_case(xt, want):
        g = gs[xt.shape[0]]
        x_t = xt.T.contiguous()
        nbytes = s_f.numel() * 5 + 4 * (xt.numel() + g.numel())
        return (lambda: sell_dvals(s_f, xt, g),
                lambda: sell_dvals_plain(s_f, xt, g),
                lambda: torch.sparse.sampled_addmm(a_csr, x_t, g, beta=0.0),
                nbytes, 2 * nnz * xt.shape[0], want)

    def oracle(x):
        g64 = gs[x.shape[0]].double()
        x64 = torch.from_numpy(x).to(dev).double()
        live = s_f >= 0
        j, t, _, r = torch.nonzero(live, as_tuple=True)
        rows, cols = t * 128 + s_f[live].long(), j * 128 + r
        acc = torch.zeros(rows.numel(), dtype=torch.float64, device=dev)
        for b in range(x64.shape[0]):
            acc += x64[b][rows] * g64[b][cols]
        want = torch.zeros(s_f.shape, dtype=torch.float64, device=dev)
        want[live] = acc
        return want

    return {"sell_grad": grad_case}, oracle


def step_times(apply, params, m, n, dev) -> dict:
    """Forward and fwd+bwd (dx and both value gradients) per call at B = 1
    and 8, CUDA events after the read flush, beside their bytes bounds."""
    st = apply.statics
    hbm = detect_hbm_gbps() * 1e9
    slots_f, slots_t = st["s_f"].numel(), st["s_t"].numel()
    vals, vals_t = params["vals"], params["vals_t"]
    out = {}
    for batch in BATCHES:
        x = torch.from_numpy(generators.random_sparse_batch(
            batch, m, 0.5, seed=30 + batch)).to(dev)
        g = torch.from_numpy(np.random.default_rng(31).uniform(
            -1, 1, (batch, n)).astype(np.float32)).to(dev)
        xr = x.clone().requires_grad_()

        def fwd():
            with torch.no_grad():
                return apply(params, x)

        def step():
            return torch.autograd.grad(apply(params, xr), [vals, vals_t, xr],
                                       g)

        xy = 4 * batch * (m + n)                     # x and y, or g and dx
        fwd_bytes = slots_f * 5 + xy
        step_bytes = fwd_bytes + slots_t * 5 + xy + (slots_f + slots_t) * 5 \
            + 2 * xy
        row = {"fwd_ms": device_time(fwd, name="fwd").seconds * 1e3,
               "step_ms": device_time(step, name="step").seconds * 1e3,
               "fwd_bound_ms": fwd_bytes / hbm * 1e3,
               "step_bound_ms": step_bytes / hbm * 1e3}
        out[str(batch)] = row
        print(f"training step B={batch}: forward {row['fwd_ms'] * 1e3:.2f} "
              f"us (bound {row['fwd_bound_ms'] * 1e3:.2f}), fwd+bwd "
              f"{row['step_ms'] * 1e3:.2f} us (bound "
              f"{row['step_bound_ms'] * 1e3:.2f}, "
              f"{step_bytes / 1e6:.1f} MB)")
    return out


def full_registry_path() -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 13: the full registry's own entries at the headline workload
    through ``SpmvTester``, each against the oracle and timed, its
    launches counted from just before it to just after. Returns the
    launches and the entries' packs."""
    packs: dict[str, object] = {}

    def cached(e):
        def prepare(a, d):
            if e["name"] not in packs:      # the same A at B = 1 and 8
                t0 = time.perf_counter()
                packs[e["name"]] = e["prepare"](a, d)
                print(f"   {e['name']}: pack + upload "
                      f"{time.perf_counter() - t0:.1f} s, "
                      f"{format_bytes(packs[e['name']]) / 1e6:.2f} MB read")
            return packs[e["name"]]
        return prepare

    entries = registry(full=True)[4:]
    require([e["name"] for e in entries] == list(FULL_KERNELS),
            f"full registry {[e['name'] for e in entries]}")
    counts = {e["name"]: dict.fromkeys(ALL_WRAPPERS, 0) for e in entries}
    for batch in BATCHES:
        tester = SpmvTester(SpmvConfig(batch=batch), device="cuda")
        print(f"-- full registry, B={batch}")
        for e in entries:
            entry = KernelEntry(e["name"], cached(e), e["run"])
            torch.cuda.synchronize()
            zero_counts()
            rep = tester.check(entry, time_it=True)
            torch.cuda.synchronize()
            entry_counts = read_counts(ALL_WRAPPERS)
            tally(entry_counts)
            for k, v in entry_counts.items():
                counts[e["name"]][k] += v
            require(rep.ok, f"{e['name']} B={batch}: {rep}")
            t = rep.timing
            share = roofline_fraction(t.bytes_moved, t.seconds)
            require(share <= ARTIFACT_SHARE,
                    f"{e['name']}: roofline share {share:.3f} is an artifact")
            print(f"   {e['name']}: max|y-oracle|={rep.max_abs_err:.3e}, "
                  f"{t.seconds * 1e6:.2f} us, {t.nnz_per_s / 1e9:.3f} "
                  f"Gnnz/s, roofline {share:.3f}")
    launched = {name: {k: v for k, v in c.items() if v}
                for name, c in counts.items()}
    print("launches on the full registry:", json.dumps(launched))
    for name, kernels in FULL_KERNELS.items():
        if name == "tcsr_cuda":
            require(any(launched[name].get(k) for k in kernels),
                    f"{name}: neither K7 nor K6 launched")
            require(set(launched[name]) <= set(kernels),
                    f"{name}: launched {launched[name]}")
        else:
            require(set(launched[name]) == set(kernels),
                    f"{name}: launched {launched[name]}, want {kernels}")
    return launched, packs


def registry_block_cases(a, packs, dev):
    """K6, K7, K4 and K9 on the full registry's own headline packs
    (``bsr_cuda`` at block_m 512, ``tcsr_cuda``'s SELL tier, ``rsell_cuda``
    (K4 alone), ``asp_cuda`` with its full plan), where 48 of each one's 49
    counted launches land: kernel, plain version, library call (cuBLAS,
    cuSPARSE CSR), and the yardstick kernel on the same A (K2 on the dense
    A, K1 on its SELL pack)."""
    m, n = a.shape
    nnz = int((a != 0).sum())
    a_dev = torch.from_numpy(a).to(dev)
    at_csr = torch.from_numpy(np.ascontiguousarray(a.T)).to(dev) \
        .to_sparse_csr()
    b, t = packs["bsr_cuda"], packs["tcsr_cuda"]
    r, f = packs["rsell_cuda"], packs["asp_cuda"]
    require(t.bsr is None and t.vals.shape[0] > 0,
            f"tcsr_cuda's headline pack: {t!r}")
    sell = SellMatrix.from_dense(a, device=dev)
    np_ = r.padded[1]
    plan = f._full_plan()
    k = f._count(plan.numel())

    def rsell_case(xt, y_ref):
        args = (r.cj, r.ct, r.idx, r.vals, xt)
        nbytes = r.device_bytes() + 4 * (xt.numel() + xt.shape[0] * np_)
        want = y_ref
        if r.perm_src is not None:          # the pack's column order
            want = np.zeros((y_ref.shape[0], np_), np.float32)
            want[:, r.inv_perm[:n]] = y_ref
        return (lambda: rsell_spmm(*args, n_padded=np_,
                                   n=np_ if r.perm_src is not None else n,
                                   plan=r._work),
                lambda: rsell_spmm_plain(
                    *args, n_padded=np_,
                    n=np_ if r.perm_src is not None else n),
                cusparse(at_csr, xt), nbytes, 2 * nnz * xt.shape[0], want)

    def asp_case(xt, y_ref):
        nbytes = 4 * (plan.numel() * 128 * n + xt.numel() + xt.shape[0] * n
                      + plan.numel() + 1)
        return (lambda: asp_spmm(plan, k, f.a_pad, xt, n=n),
                lambda: asp_spmm_plain(plan, k, f.a_pad, xt, n=n),
                lambda: dense_torch(a_dev, xt), nbytes,
                2 * plan.numel() * 128 * n * xt.shape[0], y_ref)

    def bsr_case(xt, y_ref):
        args = (b.bi, b.bj, b.blocks, xt)
        nbytes = b.device_bytes() + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: bsr_spmm(*args, n_padded=b.padded[1], n=n,
                                 plan=b._work),
                lambda: bsr_spmm_plain(*args, n_padded=b.padded[1], n=n),
                lambda: dense_torch(a_dev, xt), nbytes,
                2 * nnz * xt.shape[0], y_ref)

    def bsell_case(xt, y_ref):
        args = (t.s_bi, t.s_bj, t.idx, t.vals, xt)
        nbytes = t.device_bytes() + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: bsell_spmm(*args, n_padded=t.padded[1], n=n,
                                   plan=t._work),
                lambda: bsell_spmm_plain(*args, n_padded=t.padded[1], n=n),
                cusparse(at_csr, xt), nbytes, 2 * nnz * xt.shape[0], y_ref)

    k1 = ("K1", lambda xt: sell_spmm(sell.idx, sell.vals, xt, n=n))
    k2 = ("K2", lambda xt: dense_cuda(a_dev, xt))
    yardsticks = {"bsr_spmv": k2, "bsell_spmv": k1, "rsell_spmv": k1,
                  "asp_spmv": k2}
    return ({"bsr_spmv": bsr_case, "bsell_spmv": bsell_case,
             "rsell_spmv": rsell_case, "asp_spmv": asp_case}, yardsticks)


def check_registry_blocks(a, packs, x1, x8, dev) -> dict[str, dict]:
    """Phase 13b: K6, K7, K4 and K9 on the full registry's headline packs
    against their plain versions and the oracle, timed beside the library
    call and the yardstick kernel (K2 and cuBLAS for ``bsr_cuda`` and
    ``asp_cuda``, K1 and cuSPARSE for ``tcsr_cuda`` and ``rsell_cuda``);
    then K4 and K9 give the same bits on two calls, and K9 runs through a
    static, a device and an explicit plan and on an all-zero X."""
    print("-- K6, K7, K4 and K9 on the full registry's headline packs")
    cases, yardsticks = registry_block_cases(a, packs, dev)
    res = check_kernels(cases, lambda x: reference.sgemm_cpu(x, a),
                        (x1[None, :], x8), dev)
    labels = {"bsr_spmv": "bsr_cuda K6", "bsell_spmv": "tcsr_cuda K7",
              "rsell_spmv": "rsell_cuda K4", "asp_spmv": "asp_cuda K9"}
    for batch, x in zip(BATCHES, (x1[None, :], x8)):
        xt = torch.from_numpy(x).to(dev)
        for name, (label, fn) in yardsticks.items():
            row = res[name]["by_batch"][batch]
            row["yardstick"] = label
            row["yardstick_ms"] = device_time(lambda: fn(xt),
                                              name=label).seconds * 1e3
        print(f"   B={batch}: " + "; ".join(
            f"{labels[k]} {r['ms'] * 1e3:.2f} us | {r['yardstick']} "
            f"{r['yardstick_ms'] * 1e3:.2f} us | library "
            f"{r['library_ms'] * 1e3:.2f} us"
            for k, r in ((k, res[k]["by_batch"][batch]) for k in labels)))
        for name in ("rsell_spmv", "asp_spmv"):      # the same bits twice
            kern = cases[name](xt, reference.sgemm_cpu(x, a))[0]
            y1, y2 = kern(), kern()
            torch.cuda.synchronize()
            require(torch.equal(y1, y2), f"{name} B={batch}: two calls "
                                         "gave different bits")
    check_asp_plans(packs["asp_cuda"], a, x8, dev)
    return res


def check_asp_plans(f: AspMatrix, a, x8, dev) -> None:
    """K9 on the headline ASP matrix through a static (host), a device and
    an explicit plan (the windows in reverse, the zero window first) on an
    X with a quarter of its windows live, and on an all-zero X."""
    m, n = a.shape
    live = (np.arange(m) // 128) % 4 == 2
    xs = np.where(live, x8, 0.0).astype(np.float32)
    xt = torch.from_numpy(xs).to(dev)
    y_ref = reference.sgemm_cpu(xs, a)
    explicit = np.r_[f.n_units, np.arange(f.n_units)[::-1]].astype(np.int32)
    ys = {"static": spmm(f, xs), "device": spmm(f, xt),
          "explicit": f.spmm(xs, plan=explicit)}
    zero = spmm(f, torch.zeros_like(xt))
    torch.cuda.synchronize()
    errs = {k: max_err(y, y_ref) for k, y in ys.items()}
    print(f"   asp_cuda K9 plans (1/4 windows live, B=8): |y-oracle| "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; all-zero X -> zero: {int(torch.count_nonzero(zero)) == 0}")
    require(max(errs.values()) <= ATOL and max_err(ys["device"],
                                                   ys["static"]) <= PLAIN_ATOL,
            f"asp_cuda K9 plans disagree: {errs}")
    require(int(torch.count_nonzero(zero)) == 0, "K9: all-zero X gave y != 0")


def bell_kernel_cases(a, dev):
    """K12 on the headline matrix's BELL pack (block_m 512)."""
    n = a.shape[1]
    nnz = int((a != 0).sum())
    f = BellMatrix.from_dense(a, device=dev)
    at_csr = torch.from_numpy(np.ascontiguousarray(a.T)).to(dev) \
        .to_sparse_csr()
    print(f"   {f!r}, read_bytes {f.read_bytes() / 1e6:.2f} MB")

    def bell_case(xt, y_ref):
        args = (f.bitmap, f.vals, xt)
        nbytes = f.read_bytes() + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: bell_spmm(*args, block_m=f.block_m, n=n),
                lambda: bell_spmm_plain(*args, block_m=f.block_m, n=n),
                cusparse(at_csr, xt), nbytes, 2 * nnz * xt.shape[0], y_ref)

    return {"bell_spmv": bell_case}


def check_bell_block_sizes(dev) -> None:
    """K12 on a small unaligned matrix at block_m 128 and 256."""
    a = generators.random_sparse_matrix(1000, 700, density=0.3, seed=12)
    for block_m in (128, 256):
        f = BellMatrix.from_dense(a, block_m=block_m, device=dev)
        for batch in BATCHES:
            x = generators.random_sparse_batch(batch, 1000, 0.5, seed=13)
            xt = torch.from_numpy(x).to(dev)
            yk = bell_spmm(f.bitmap, f.vals, xt, block_m=block_m, n=700)
            e_plain = max_err(yk, bell_spmm_plain(f.bitmap, f.vals, xt,
                                                  block_m=block_m, n=700))
            e_ref = max_err(yk, reference.sgemm_cpu(x, a))
            print(f"bell block_m={block_m} (w {f.w}) 1000x700 B={batch}: "
                  f"|k-plain|={e_plain:.3e} |k-oracle|={e_ref:.3e}")
            require(e_plain <= PLAIN_ATOL and e_ref <= ATOL,
                    f"bell block_m={block_m} B={batch} disagrees")


def check_binned(a_s, x1_s, x8_s, dev) -> int:
    """Binned SELL on the skew matrix: K1 once per bucket, K5 once a call
    on the buckets' outputs in place; and auto_format's binned route on a
    skewed 65536^2 CSR. Returns K5's launches here."""
    t0 = time.perf_counter()
    f = BinnedSellMatrix.from_dense(a_s, device=dev)
    k5 = 0
    print(f"-- binned SELL on the skew matrix: {f!r}, pack + upload "
          f"{time.perf_counter() - t0:.1f} s")
    for x in (x1_s, x8_s):
        xt = torch.from_numpy(x).to(dev)
        torch.cuda.synchronize()
        zero_counts()
        y = spmv(f, xt) if x.ndim == 1 else spmm(f, xt)
        torch.cuda.synchronize()
        counts = read_counts(("sell_spmv", "permute"))
        tally(counts)
        want = reference.sgemv_cpu(x, a_s) if x.ndim == 1 \
            else reference.sgemm_cpu(x, a_s)
        err = max_err(y, want)
        batch = 1 if x.ndim == 1 else x.shape[0]
        print(f"   B={batch}: launches {json.dumps(counts)}, "
              f"|y-oracle|={err:.3e}")
        require(counts == {"sell_spmv": len(f.widths), "permute": 1},
                f"binned B={batch}: K1 x{len(f.widths)} and K5 x1 expected")
        require(err <= ATOL, f"binned B={batch} disagrees with the oracle")
        k5 += counts["permute"]
    n = 65536
    rng = np.random.default_rng(0)
    rows = np.sort(rng.integers(0, n, 200))
    cols = rng.integers(0, n, 200)
    vals = rng.uniform(-1, 1, 200).astype(np.float32)
    csr = CsrMatrix.from_coo(n, n, rows, cols, vals)
    stats = dict(density=1e-5, nnz=200, empty_block_frac=0.0, w_global=12,
                 w_typical=8.0, slot_tile_bytes=1000)
    b = auto_format(csr, expect_batch=48, stats=stats)   # device=None: GPU
    require(isinstance(b, BinnedSellMatrix),
            f"auto_format gave {type(b).__name__}, not BinnedSellMatrix")
    x = np.zeros((2, n), np.float32)
    x[:, rows] = rng.uniform(-1, 1, (2, 200))
    want = np.zeros((2, n))
    np.add.at(want.T, cols, (x[:, rows] * vals).T.astype(np.float64))
    err = max_err(spmm(b, torch.from_numpy(x).to(dev)), want)
    print(f"   auto_format(65536^2 skewed CSR, B=48) -> {b!r}; "
          f"|y-oracle|={err:.3e}")
    require(err <= ATOL, "binned route disagrees with the oracle")
    return k5


def repeated_entries_csr() -> CsrMatrix:
    """A 4096^2 CsrMatrix, d ~ 0.1, built from COO triplets of which 2% are
    repeats (from_coo keeps them; the SELL pack gives each its own slot)."""
    rng = np.random.default_rng(62)
    nnz = 1_600_000
    rows = rng.integers(0, 4096, nnz)
    cols = rng.integers(0, 4096, nnz)
    rows[:32_000], cols[:32_000] = rows[-32_000:], cols[-32_000:]
    vals = rng.uniform(-1, 1, nnz).astype(np.float32)
    return CsrMatrix.from_coo(4096, 4096, rows, cols, vals)


def floors_study(dev) -> tuple[list[dict], dict]:
    """Phase 15: K11 checked at every floors point and on a pad-collision
    matrix, then the timed study, K11's launches counted over it alone.
    Returns (the study's rows, K11's kernel row)."""
    t0 = time.perf_counter()
    loads = report.workloads(dev)
    print(f"-- floors study: packs + upload {time.perf_counter() - t0:.1f} s")
    errs = report.check_points(loads)
    bait = generators.random_sparse_matrix(4096, 4096, density=0.1, seed=61)
    bait[0, :] = 1.0           # every column has an offset-0 entry
    bait_sell = SellMatrix.from_dense(bait, device=dev)
    for batch in (1, 32, 40):
        x = generators.random_sparse_batch(batch, 4096, 0.5, seed=61)
        errs["pad collision", batch] = report.check_mxu(bait_sell, x, bait)
    dup = repeated_entries_csr()
    x = generators.random_sparse_batch(8, dup.shape[0], 0.5, seed=62)
    errs["repeated entries", 8] = report.check_mxu(
        SellMatrix.from_csr(dup, device=dev), x, dup.to_dense())
    for key, (e_plain, e_ref) in errs.items():
        print(f"   K11 {key}: |k-plain|={e_plain:.3e} |k-oracle|={e_ref:.3e}")
    for wl in loads:           # K1's ring kernel (from 9 rows) at B = 32 and 40
        s = wl["sell"]
        for batch in (32, 40):
            x = report.grid_batch(batch) if batch == 32 else \
                generators.random_sparse_batch(batch, 4096, 0.5, seed=63)
            xt = torch.from_numpy(x).to(dev)
            yk = sell_spmm(s.idx, s.vals, xt, n=4096)
            e_plain = max_err(yk, sell_spmm_plain(s.idx, s.vals, xt, n=4096))
            e_ref = max_err(yk, reference.sgemm_cpu(x, wl["a"]))
            print(f"   K1 d={wl['density']} B={batch}: |k-plain|={e_plain:.3e} "
                  f"|k-oracle|={e_ref:.3e}")
            require(e_plain <= PLAIN_ATOL and e_ref <= ATOL,
                    f"K1 d={wl['density']} B={batch} disagrees")
    torch.cuda.synchronize()
    zero_counts()
    rows = report.floors(loads=loads, device=dev, check=False)
    torch.cuda.synchronize()
    study = read_counts(("sell_mxu_spmm", "sell_spmv"))
    tally(study)
    k11 = study["sell_mxu_spmm"]
    require(k11 > 0, "sell_mxu_spmm: no launch in the floors study")
    for r in rows:
        share = r["bound_ms"] / r["mxu_ms"]
        require(share <= ARTIFACT_SHARE,
                f"K11 d={r['density']} B={r['batch']}: share {share:.3f}")
        r["mxu_share"] = share
    head = next(r for r in rows
                if (r["density"], r["batch"]) == FLOORS_HEAD)
    wl = next(w for w in loads if w["density"] == FLOORS_HEAD[0])
    s = wl["sell"]
    xt = torch.from_numpy(report.grid_batch(FLOORS_HEAD[1])).to(dev)
    plain_ms = device_time(lambda: sell_mxu_spmm_plain(s.idx, s.vals, xt),
                           warmup=1, reps=5).seconds * 1e3
    print(f"sell_mxu_spmm d={FLOORS_HEAD[0]} B={FLOORS_HEAD[1]}: "
          f"{head['mxu_ms'] * 1e3:.2f} us, bound {head['bound_ms'] * 1e3:.2f} "
          f"us ({head['bound_by']}), tensor-core floor (3xTF32) "
          f"{head['mxu_tc_floor_ms'] * 1e3:.2f} us, share "
          f"{head['mxu_share']:.3f} | plain {plain_ms * 1e3:.2f} us | "
          f"library {head['cusparse_ms'] * 1e3:.2f} us; launches {k11}")
    row = {"name": "sell_mxu_spmm", "route": "cuda",
           "source": META["sell_mxu_spmm"][0],
           "replaces": META["sell_mxu_spmm"][1], "launches": k11,
           "max_abs_err": max(e for e, _ in errs.values()),
           "ms": head["mxu_ms"], "plain_ms": plain_ms,
           "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
           "library_ms": head["cusparse_ms"],
           "by_point": {f"d={r['density']},B={r['batch']}": r for r in rows}}
    return rows, row


def kernel_rows(results, launches, batch_of) -> list[dict]:
    rows = []
    for name, res in results.items():
        main = res["by_batch"][batch_of.get(name, 1)]
        rows.append({
            "name": name, "route": "cuda", "source": META[name][0],
            "replaces": META[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"]
                               for r in res["by_batch"].values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "by_batch": {str(b): r for b, r in res["by_batch"].items()},
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_info()
    print(f"card: {card['line']}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_kernels()
    dev = torch.device("cuda")

    launches = main_path()

    cfg = SpmvConfig()
    a = generators.random_sparse_matrix(cfg.m, cfg.n, density=cfg.density,
                                        seed=cfg.seed)
    x1 = generators.random_sparse_vector(cfg.m, cfg.x_density, cfg.seed)
    x8 = generators.random_sparse_batch(8, cfg.m, cfg.x_density, cfg.seed)
    results = check_kernels(kernel_cases(a, dev),
                            lambda x: reference.sgemm_cpu(x, a),
                            (x1[None, :], x8), dev)
    check_device_plan(a, x1, dev)
    sweep = check_awsp_sweep(dev)
    check_lanes(a, x8, dev)

    a_s = generators.random_sparse_matrix(
        SKEW["m"], SKEW["n"], density=SKEW["density"], seed=SKEW["seed"],
        distribution=SKEW["distribution"])
    x1_s = generators.random_sparse_vector(SKEW["m"], cfg.x_density,
                                           SKEW["seed"])
    x8_s = generators.random_sparse_batch(8, SKEW["m"], cfg.x_density,
                                          SKEW["seed"])
    r, asp, skew_launches = skew_path(a_s, x1_s, x8_s, dev)
    skew_results = check_kernels(skew_kernel_cases(a_s, r, asp, dev),
                                 lambda x: reference.sgemm_cpu(x, a_s),
                                 (x1_s[None, :], x8_s), dev)
    check_asp_device_plan(asp, a_s, x8_s, dev)
    fused_cost = fused_unpermute_cost(r, x1_s, x8_s, dev)
    check_rsell_bodies(dev)

    a_b = generators.block_pruned_matrix(
        BLOCKY["m"], BLOCKY["n"], block=BLOCKY["block"],
        keep_frac=BLOCKY["keep_frac"], fill=BLOCKY["fill"],
        seed=BLOCKY["seed"])
    x1_b = generators.random_sparse_vector(BLOCKY["m"], cfg.x_density, 0)
    x8_b = generators.random_sparse_batch(8, BLOCKY["m"], cfg.x_density, 0)
    f1, f8, block_launches = block_path(a_b, x1_b, x8_b, dev)
    csr = generators.stencil_csr(STENCIL)
    nd = csr.shape[0]
    x1_d = generators.random_sparse_vector(nd, cfg.x_density, 0)
    x8_d = generators.random_sparse_batch(8, nd, cfg.x_density, 0)
    d, banded_launches = banded_path(csr, x1_d, x8_d, dev)
    block_results = check_kernels(block_kernel_cases(a_b, f1, f8, dev),
                                  lambda x: reference.sgemm_cpu(x, a_b),
                                  (x1_b[None, :], x8_b), dev)
    banded_results = check_kernels(banded_kernel_cases(csr, d, dev),
                                   csr_oracle(csr), (x1_d[None, :], x8_d),
                                   dev)
    check_block_extras(a_b, x8_b, dev)

    csr_a = CsrMatrix.from_dense(a)
    apply, params, k10 = training_path(csr_a, a, dev)
    k10 += training_run(csr_a, dev)
    cases, grad_oracle = grad_kernel_cases(a, apply.statics, dev)
    grad_results = check_kernels(cases, grad_oracle, (x1[None, :], x8), dev)
    steps = step_times(apply, params, cfg.m, cfg.n, dev)
    print(json.dumps({"training_step": steps}))

    full_launches, full_packs = full_registry_path()
    registry_blocks = check_registry_blocks(a, full_packs, x1, x8, dev)
    print("-- K12 on the headline matrix")
    bell_results = check_kernels(bell_kernel_cases(a, dev),
                                 lambda x: reference.sgemm_cpu(x, a),
                                 (x1[None, :], x8), dev)
    check_bell_block_sizes(dev)
    binned_k5 = check_binned(a_s, x1_s, x8_s, dev)
    _, k11_row = floors_study(dev)

    kernels = kernel_rows(results, launches, {}) + \
        kernel_rows(skew_results, skew_launches, PATH_BATCH) + \
        kernel_rows(block_results, block_launches, PATH_BATCH) + \
        kernel_rows(banded_results, banded_launches, PATH_BATCH) + \
        kernel_rows(grad_results, {"sell_grad": k10}, PATH_BATCH) + \
        kernel_rows(bell_results, full_launches["bell_cuda"], {}) + \
        [k11_row]
    require(len(kernels) == 12, f"{len(kernels)} kernel rows, want 12")
    for row in kernels:     # K6, K7, K4 and K9 where most of their launches land
        if row["name"] in registry_blocks:
            row["by_workload"] = {"full_registry_headline": {
                str(b): r for b, r in
                registry_blocks[row["name"]]["by_batch"].items()}}
    for row in kernels:
        row["launches_all_paths"] = TOTALS[row["name"]]
        if row["name"] == "awsp_spmv":      # the sweep's live-1/4 points
            row["live_quarter"] = {str(b): sweep["by_point"][f"live=0.25,B={b}"]
                                   for b in BATCHES}
            row["sweep"] = sweep["by_point"]
            row["device_plan"] = sweep["device_plan"]
        if row["name"] == "permute":
            # K5 runs on binned SELL's path now: its launches are the binned
            # calls' (the full registry's sell_binned_cuda and phase 14's);
            # a sorted RSELL pack's unpermute rides K4 (fused_unpermute)
            row["launches"] = full_launches["sell_binned_cuda"]["permute"] \
                + binned_k5
            row["fused_unpermute"] = dict(fused_cost,
                                          runs_fused=FUSED_UNPERMUTES[0])
    print("launches summed over all paths:", json.dumps(TOTALS),
          f"; sorted-RSELL unpermutes done by K4: {FUSED_UNPERMUTES[0]}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card["line"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
