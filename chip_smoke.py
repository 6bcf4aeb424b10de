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
    cuSPARSE CSR for K7 and K8; K8 at B = 1 is one public ``DiaMatrix.spmv``
    call; it takes one vector, so B = 8 is eight launches, stacked); K8
    must give its plain version's bits, and the shifted torch form is timed
    beside it; then K8 on HPCG's 27-point stencil on its 104^3 local grid
    (``stencil_csr((104, 104, 104), points=27)``: sym, 14 stored
    diagonals), one public call, held bit for bit to its plain version and
    to the float64 CSR oracle and timed the same way (the ``by_workload``
    of its row); and runs a mixed-tier TCSR pack (the split charge set to
    0) and a BSR pack with block_m = 40 against the oracle;

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
    ``format_bytes``: BELL's and RSELL's ``read_bytes``), every launch
    counter set to 0 just before each entry and read just after:
    ``bell_cuda`` must launch K12, ``sell_binned_cuda`` K1 and K5,
    ``bsr_cuda`` K6, ``tcsr_cuda`` K7 and/or K6, ``rsell_cuda`` K4,
    ``asp_cuda`` K9, and ``ell_torch`` none;
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
    ``mma.sync`` on the tensor cores and the fused split-K sum;

and then the solver user's path on the 1M-unknown Laplacian (BENCH.md
§Solver and §AMG), reusing the banded path's DIA pack:

16. (a) the native converters must have built on the card's host; the
    AMG host setup is timed, and the level-0 prolongator's RSELL packs
    with and without them (the same bits); (b) ``cg(d, b, tol=1e-5)`` on
    K8 against CG over K8's plain version (the same iterations, iterates
    within 1e-6), its float64 residual <= 1e-4, timed per iteration
    beside K8's call and the iteration's byte bound, with the share of
    the iteration outside kernels (``torch.profiler``); (c) Lanczos
    bounds (``spectrum_bounds``, ncv 32) containing the closed-form
    lmax within 1.05x, Chebyshev-preconditioned CG in fewer iterations
    than plain CG, ``cg_multi`` on 4 right-hand sides against 4 single
    solves, and BiCGStab and GMRES residuals falling; (d) the smoothed-
    aggregation hierarchy with JAX's levels and formats (two DIA levels
    on K8, two TCSR levels on K7/K6, RSELL carriers on K4, a dense
    coarse level), its V-cycle's launches and time, an AMG-CG solve to a
    float64 residual <= 1e-4, every pack of the hierarchy held against
    its plain versions (the level-0 packs and the first TCSR level timed
    beside cuSPARSE), and ``save``/``load``: on the card the same bits,
    on the CPU a V-cycle within 1e-4; (e) a scrambled 1M-unknown chain
    routed back to DIA by ``banded_after_rcm``, solved by CG in the
    permuted space within 1e-4 of scipy's direct solve; (f) the port's
    ``entry()`` against the float64 oracle and K1 against its plain
    version. Its launches of K1, K4, K6, K7 and K8 join their rows'
    ``launches_all_paths`` and ``by_workload["solver-laplace2d-1M"]``;

and then the sharded serving path (``tpusparse_torch.parallel``), whose
list is the JAX package's ``dryrun_multichip`` (``parallel/dryrun.py``,
at full width: the headline 4096^2 for dense, SELL n/m/ring/2d and ragged
n, BSR n/m/ring/2d and AWSP n/m/ring; the skew 8192^2 for RSELL balance
and sorted and binned SELL; blockpruned-4096 for TCSR; DIA halo and n on
the Laplacian and the 27-point stencil; SpMM cases at B = 8):

17. (a) K8 with halo strips, one process: each banded operator cut into
    D = 2 and 4 slabs by the JAX package's slab rule, each slab run with
    its neighbours' edges as strips (the ring's wrap included, the vals
    strip zero on the first slab): every slab gives its plain version's
    bits and the joined slabs the unsharded K8's; (b) the list at world
    size 1 over NCCL (``initialize()`` in this process), its launches of
    K1 and K3-K8 (K8 with strips) counted, every case within 1e-4 of its
    unsharded public call and 1e-3 of the oracle, and ``comm``'s
    collectives exact; (c) meanwhile a world of 2 ranks over gloo sharing
    this card (this script as two child processes, ``--sharded-rank``;
    "transport: gloo via host"): the same list, both ranks the same y,
    within 1e-3 of the oracle and 1e-4 of (b), and CG through
    ``dia_spmm_sharded(..., "halo")`` in the unsharded K8 CG's iterations
    (445) with its bits; a child's failure fails the phase. Then, alone
    on the card, K8's strip body is timed on a slab, and
    ``bench.shard_overhead`` times the sharded call at world size 1
    against the unsharded one (SELL, DIA, TCSR). Every sharded kernel's
    row gets ``sharded_launches``, K8's row ``strip_body``;

and then, in the same world of one rank, sharded training and AMG:

18. (a) ``trainable_linear_sharded`` on the headline matrix (4096^2,
    d = 0.5): a forward and backward at B = 1 and 8 against phase 11's
    unsharded ``trainable_linear`` (y, dx, ``dvals``, ``dvals_t``: the
    same bits expected, 1e-5 the limit; whether the bits held is
    printed), y and dx within 1e-3 of the float64 oracle, each step K1
    twice and K10 twice (counted); two SGD steps on the weights and the
    activations with a falling loss; ``resync`` giving the unsharded
    re-tie's bits; (b) the grid hierarchy of the 1M-unknown Laplacian
    placed with ``shard(mesh)``: its DIA levels through the halo
    partition (K8's strip kernel counted), CG in the unsharded hierarchy's
    iterations, z within 1e-5 of its z, the float64 residual <= 1e-3;
    (c) ``smoothed_aggregation(lap, mesh=mesh)``: every level but the
    dense coarsest a ragged-SELL shard (``"rsell-shard"``, K4 counted),
    CG in phase 16's iterations with a residual within max(2 x phase 16's,
    1e-5); (d) phase 17c's two gloo children then run the train step at
    the headline (B = 8) and both AMG cases at the dry run's small sizes:
    both ranks the same bits, world 1's AMG iterations, a falling loss,
    K1, K10 and K4 launched. After the children end, the sharded step
    (fwd + bwd) is timed beside the unsharded one, and each AMG's V-cycle
    beside its unsharded one (phase 16's hierarchy for greedy), in turns. Phase 18's launches
    of K1, K4, K8 and K10 join their rows (``phase18_launches``);
19. runs the rest of the port on the card: (a) the gallery's 13
    workloads at B = 1 (``bench.gallery.run_workload``: every candidate
    held to the float64 oracle within 1e-3, then timed; no share above
    1.05), printed as one ``{"gallery": ...}`` line (route, best, regret,
    each row's us, share and pack seconds); (b) ``bench.dynamic``'s AWSP
    variants at its defaults at B = 1 and 8 and ASP's at B = 1 (each
    pattern: the device plan's y the host plan's bits, all within 1e-3);
    (c) ``bench.scale`` at 65536^2, d = 0.02, with its train step (or the
    gate that names its budget); (d) ``python -m tpusparse_torch check``,
    ``mtx`` and ``solve --precond amg`` on ``data/fem_mesh_16384.mtx``
    and ``report --sections canonical``, each a subprocess that must pass;
    (e) the 13 examples in this process, each through its ``main()``.
    The launches of (a), (b), (c) and (e) are counted, join ``TOTALS``, and
    stand in each kernel row as ``phase19_launches``.

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
import statistics
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
from tpusparse_torch.kernels.dia_spmv import (dia_spmv, dia_spmv_plain, fits,
                                              halo_rows)
from tpusparse_torch.kernels.permute import (permute_columns,
                                             permute_columns_plain)
from tpusparse_torch.kernels.rsell_spmv import rsell_spmm, rsell_spmm_plain
from tpusparse_torch.kernels.sell_grad import sell_dvals, sell_dvals_plain
from tpusparse_torch.kernels.sell_mxu_spmm import (sell_mxu_spmm,
                                                   sell_mxu_spmm_plain)
from tpusparse_torch.kernels.sell_spmv import sell_spmm, sell_spmm_plain
from tpusparse_torch.nn import SparseLinear
from tpusparse_torch.parallel.sparse import halo_slab_rows
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
STENCIL27 = (104, 104, 104)     # HPCG's local grid (hpcg.dat)
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
        nbytes = format_bytes(sell) + 4 * (xt.numel() + xt.shape[0] * n)
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
        nbytes = r.read_bytes() + 4 * (xt.numel() + xt.shape[0] * np_)
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


def sell_tier_bytes(t: TcsrMatrix) -> int:
    """The live bytes of a TCSR pack's SELL tier, all that K7 reads."""
    return t.read_bytes() - (0 if t.bsr is None else t.bsr.read_bytes())


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
        nbytes = sell_tier_bytes(f1) + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: bsell_spmm(*args, n_padded=f1.padded[1], n=n,
                                   plan=f1._work),
                lambda: bsell_spmm_plain(*args, n_padded=f1.padded[1], n=n),
                cusparse(at_csr, xt), nbytes, 2 * nnz * xt.shape[0], y_ref)

    def bsr_case(xt, y_ref):
        args = (b.bi, b.bj, b.blocks, xt)
        nbytes = format_bytes(b) + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: bsr_spmm(*args, n_padded=b.padded[1], n=n,
                                 plan=b._work),
                lambda: bsr_spmm_plain(*args, n_padded=b.padded[1], n=n),
                lambda: dense_torch(a_dev, xt), nbytes,
                2 * nnz * xt.shape[0], y_ref)

    return {"bsell_spmv": bsell_case, "bsr_spmv": bsr_case}


def banded_kernel_cases(csr, d: DiaMatrix, dev):
    """K8 on a DIA pack. B = 1 is one public ``DiaMatrix.spmv`` call, the
    call users make (no copy around it); K8 takes one vector, so B = 8 is
    eight launches (and eight calls of the plain version), stacked."""
    n = d.shape[1]
    at_csr = torch_csr_of_at(csr, dev)

    def rows(fn, **kw):
        return lambda xt: torch.stack([fn(d.offsets, d.vals, v, sym=d.sym,
                                          n=n, **kw) for v in xt])

    def dia_case(xt, y_ref):
        if xt.shape[0] == 1:
            v = xt[0]
            kern = lambda: d.spmv(v)[None]                     # noqa: E731
            plain = lambda: dia_spmv_plain(                     # noqa: E731
                d.offsets, d.vals, v, sym=d.sym, n=n)[None]
        else:
            kern = lambda: rows(dia_spmv, plan=d.plan)(xt)     # noqa: E731
            plain = lambda: rows(dia_spmv_plain)(xt)            # noqa: E731
        nbytes = d.device_bytes() + 4 * (xt.numel() + xt.shape[0] * n)
        return (kern, plain, cusparse(at_csr, xt), nbytes,
                2 * csr.nnz * xt.shape[0], y_ref)

    return {"dia_spmv": dia_case}


def check_dia(results: dict, d: DiaMatrix, x1, dev) -> None:
    """K8 is bit-exact against its plain version (the same fp32 products
    added in the same order); the shifted torch form's time on x1."""
    for b, row in results["dia_spmv"]["by_batch"].items():
        require(row["max_abs_err"] == 0.0,
                f"dia_spmv B={b}: |kernel-plain| {row['max_abs_err']:.3e}, "
                "want the same bits")
    v = torch.from_numpy(x1).to(dev)
    row = results["dia_spmv"]["by_batch"][1]
    row["shifted_ms"] = device_time(lambda: d._shifted(v[None, :])[0],
                                    name="shifted").seconds * 1e3
    row["tile"], row["smem_bytes"] = d.plan.tile, d.plan.smem_bytes
    print(f"dia_spmv: bits equal to the plain version; plan tile "
          f"{d.plan.tile}, {len(d.plan.windows)} windows, "
          f"{d.plan.smem_bytes} B; shifted torch form "
          f"{row['shifted_ms'] * 1e3:.2f} us")


def stencil27(dev) -> dict:
    """K8 on HPCG's 27-point stencil on its 104^3 local grid (sym, 14
    stored diagonals), one vector: one public call against the plain
    version bit for bit and the float64 CSR oracle, timed beside its bound,
    cuSPARSE and the shifted form."""
    t0 = time.perf_counter()
    csr = generators.stencil_csr(STENCIL27, points=27)
    d = DiaMatrix.from_csr(csr, device=dev)
    n = d.shape[1]
    require(d.sym and len(d.offsets) == 14 and fits(d.offsets, d.sym, n),
            f"27-point stencil packed as {d!r}")
    print(f"-- K8 on the 27-point stencil {STENCIL27}: {d!r}, pack + upload "
          f"{time.perf_counter() - t0:.1f} s")
    x1 = generators.random_sparse_vector(n, 0.5, 0)
    res = check_kernels(banded_kernel_cases(csr, d, dev), csr_oracle(csr),
                        (x1[None, :],), dev)
    check_dia(res, d, x1, dev)
    return res["dia_spmv"]["by_batch"][1]


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
    counted. Returns (apply, params, K10 launches, resync)."""
    m, n = csr.shape
    t0 = time.perf_counter()
    apply, params, masks, resync = trainable_linear(csr)   # device=None: GPU
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
    return apply, params, k10, resync


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
        nbytes = r.read_bytes() + 4 * (xt.numel() + xt.shape[0] * np_)
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
        nbytes = format_bytes(b) + 4 * (xt.numel() + xt.shape[0] * n)
        return (lambda: bsr_spmm(*args, n_padded=b.padded[1], n=n,
                                 plan=b._work),
                lambda: bsr_spmm_plain(*args, n_padded=b.padded[1], n=n),
                lambda: dense_torch(a_dev, xt), nbytes,
                2 * nnz * xt.shape[0], y_ref)

    def bsell_case(xt, y_ref):
        args = (t.s_bi, t.s_bj, t.idx, t.vals, xt)
        nbytes = sell_tier_bytes(t) + 4 * (xt.numel() + xt.shape[0] * n)
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


# -- phase 16: the solver path ------------------------------------------

SOLVER_WRAPPERS = {"sell_spmv": sell_spmm, "rsell_spmv": rsell_spmm,
                   "bsr_spmv": bsr_spmm, "bsell_spmv": bsell_spmm,
                   "dia_spmv": dia_spmv}
SOLVER_TOL = 1e-5
# the JAX host setup's hierarchy of the 1024^2 Laplacian (default
# arguments): level sizes and formats, and its operator complexity
AMG_LEVELS = ((1048576, "DiaMatrix"), (175104, "DiaMatrix"),
              (19537, "TcsrMatrix"), (2181, "TcsrMatrix"), (247, "dense"))
AMG_OP_CX = "1.34"


def timed_ms(fn):
    """(result, device ms) of one call, bracketed by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kernel_busy_ms(fn) -> tuple[float, float | None]:
    """Host wall ms of ``fn()`` under ``torch.profiler`` (synchronized; the
    profiler slows the host) and the ms its CUDA kernels took on the
    device (None when the profiler recorded no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    return wall, (dev_us / 1e3 if dev_us > 0 else None)


def solver_counts(phase: dict, fn):
    """Run ``fn`` with every launch counter at 0, add its launches of the
    solver path's kernels to the phase's and to TOTALS, return its
    result and those launches."""
    torch.cuda.synchronize()
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts(SOLVER_WRAPPERS)
    tally(counts)
    for k, v in counts.items():
        phase["launches"][k] += v
    return out, counts


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def residual64(sp, z, b) -> float:
    """||b - A z|| / ||b|| in float64 (``sp`` is A, symmetric, scipy)."""
    z = z.detach().double().cpu().numpy() if isinstance(z, torch.Tensor) \
        else np.asarray(z, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - sp @ z) / np.linalg.norm(b))


def plain_spmv(pack, x):
    """The plain versions of the kernels a solver-path pack launches, on
    the same device tensors: K8 (DIA), K4 (RSELL), K7 + K6 (TCSR)."""
    if isinstance(pack, DiaMatrix):
        return dia_spmv_plain(pack.offsets, pack.vals, x, sym=pack.sym,
                              n=pack.shape[1])
    if isinstance(pack, RsellMatrix):
        return rsell_spmm_plain(pack.cj, pack.ct, pack.idx, pack.vals,
                                x[None], n_padded=pack.padded[1],
                                n=pack.shape[1])[0]
    if isinstance(pack, SellMatrix):
        return sell_spmm_plain(pack.idx, pack.vals, x[None],
                               n=pack.shape[1])[0]
    n, y = pack.shape[1], None
    if pack.vals.shape[0]:
        y = bsell_spmm_plain(pack.s_bi, pack.s_bj, pack.idx, pack.vals,
                             x[None], n_padded=pack.padded[1], n=n)[0]
    if pack.bsr is not None:
        b = pack.bsr
        yd = bsr_spmm_plain(b.bi, b.bj, b.blocks, x[None],
                            n_padded=b.padded[1], n=n)[0]
        y = yd if y is None else y + yd
    return torch.zeros(n, device=x.device) if y is None else y


def pack_kernels(pack) -> tuple[str, ...]:
    if isinstance(pack, DiaMatrix):
        return ("dia_spmv",)
    if isinstance(pack, RsellMatrix):
        return ("rsell_spmv",)
    if isinstance(pack, SellMatrix):
        return ("sell_spmv",)
    return (("bsell_spmv",) if pack.vals.shape[0] else ()) + \
        (("bsr_spmv",) if pack.bsr is not None else ())


def hold_pack(where: str, pack, sp, dev, seed: int, timed: bool) -> dict:
    """A solver-path pack's public call (its kernels) against the plain
    versions on the same vector and against float64 scipy (``sp`` is the
    packed A, y = x @ A); with ``timed``, the kernel, plain version and
    cuSPARSE (CSR of A.T) timed beside the bytes bound."""
    m, n = pack.shape
    x = torch.from_numpy(generators.random_sparse_vector(m, 0.5, seed)) \
        .to(dev)
    yk, yp = pack.spmv(x), plain_spmv(pack, x)
    torch.cuda.synchronize()
    scale = max(1.0, float(yp.abs().max()))
    e_plain = max_err(yk, yp)
    e_ref = max_err(yk, sp.T @ x.double().cpu().numpy())
    require(e_plain <= PLAIN_ATOL * scale and e_ref <= ATOL * scale,
            f"{where}: |kernel-plain| {e_plain:.3e} or |kernel-oracle| "
            f"{e_ref:.3e} above {PLAIN_ATOL}/{ATOL} x {scale:.3g}")
    row = {"shape": [m, n], "max_abs_err": e_plain,
           "max_abs_err_oracle": e_ref, "kernels": pack_kernels(pack)}
    if timed:
        at = sp.T.tocsr().astype(np.float32)
        at_csr = torch.sparse_csr_tensor(
            torch.from_numpy(at.indptr.astype(np.int64)),
            torch.from_numpy(at.indices.astype(np.int64)),
            torch.from_numpy(at.data), size=(n, m)).to(dev)
        nbytes = format_bytes(pack) + 4 * (m + n)
        bound = nbytes / (detect_hbm_gbps() * 1e9) * 1e3
        row.update(
            ms=device_time(lambda: pack.spmv(x)).seconds * 1e3,
            plain_ms=device_time(lambda: plain_spmv(pack, x), warmup=1,
                                 reps=5).seconds * 1e3,
            library_ms=device_time(lambda: at_csr @ x).seconds * 1e3,
            bound_ms=bound, bound_by="bytes", bytes=nbytes)
        require(bound / row["ms"] <= ARTIFACT_SHARE,
                f"{where}: roofline share {bound / row['ms']:.3f}")
    print(f"   {where} {type(pack).__name__} {m}x{n}: max|k-plain|="
          f"{e_plain:.3e} max|k-oracle|={e_ref:.3e}"
          + (f" | {row['ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f}"
             f" us | plain {row['plain_ms'] * 1e3:.2f} us | cuSPARSE "
             f"{row['library_ms'] * 1e3:.2f} us" if timed else ""))
    return row


def solver_native(csr, phase: dict):
    """16a: the native converters on the card's host, and the host setup
    of the AMG hierarchy (whose aggregation runs through them)."""
    from tpusparse_torch import native
    from tpusparse_torch.amg import _aggregate, host_hierarchy
    from tpusparse_torch.formats.rsell import rsell_pack_csr

    require(native.available(),
            f"native converters unavailable: {native.build_error()}")
    t0 = time.perf_counter()
    host = host_hierarchy(csr)
    phase["amg_host_setup_s"] = time.perf_counter() - t0
    h0 = host[0][0]
    t0 = time.perf_counter()
    agg, n_agg = _aggregate(h0.sp, 0.0, use_native=True)
    t_agg = time.perf_counter() - t0
    require(np.array_equal(agg, h0.agg) and n_agg == h0.n_agg,
            "native aggregation differs from the hierarchy's")
    packs = {}
    for name, mat in (("P", h0.p), ("Pt", h0.p.T.tocsr())):
        c = CsrMatrix.from_scipy(mat.astype(np.float32))
        times = {}
        for use in (True, False):
            t0 = time.perf_counter()
            pk = rsell_pack_csr(c, sort=False, use_native=use)
            times["native" if use else "numpy"] = time.perf_counter() - t0
            packs.setdefault(name, []).append(pk)
        nat, ref = packs[name]
        require(all(np.array_equal(nat[k], ref[k])
                    for k in ("cj", "ct", "idx", "vals")),
                f"RSELL {name}: native and numpy packs differ")
        phase[f"rsell_pack_{name}_s"] = times
    phase["aggregate_native_s"] = t_agg
    print(f"-- solver path (phase 16) on the {STENCIL[0]}x{STENCIL[1]} "
          f"Laplacian, n {csr.shape[0]}")
    print(f"16a native converters built: {native.available()}; AMG host "
          f"setup {phase['amg_host_setup_s']:.2f} s; level-0 aggregation "
          f"(native) {t_agg:.3f} s (the numpy loop is not run at 1M); "
          f"RSELL P pack native {phase['rsell_pack_P_s']['native']:.2f} s / "
          f"numpy {phase['rsell_pack_P_s']['numpy']:.2f} s, Pt native "
          f"{phase['rsell_pack_Pt_s']['native']:.2f} s / numpy "
          f"{phase['rsell_pack_Pt_s']['numpy']:.2f} s (bits equal)")
    return host


def solver_cg(csr, sp, d: DiaMatrix, bt, b, phase: dict) -> int:
    """16b: CG on K8, against CG over K8's plain version; timed."""
    from tpusparse_torch.solve import cg

    n = d.shape[1]
    (z1, i1), c = solver_counts(phase, lambda: cg(d, bt, tol=SOLVER_TOL))
    require(c["dia_spmv"] > 0, "cg: no K8 launch")

    def plain(v):
        return dia_spmv_plain(d.offsets, d.vals, v, sym=d.sym, n=n)

    z2, i2 = cg(plain, bt, tol=SOLVER_TOL)
    iters = i1["iters"]
    dz = rel(z1.cpu(), z2.cpu())
    res = residual64(sp, z1, b)
    require(iters == i2["iters"] and dz <= 1e-6,
            f"cg on K8: {iters} iterations, on the plain version "
            f"{i2['iters']}; iterates {dz:.3e} apart")
    require(res <= 1e-4 and float(i1["resnorm"]) <= SOLVER_TOL
            * float(torch.linalg.norm(bt)) * 1.01,
            f"cg: float64 relative residual {res:.3e}")
    _, ms = timed_ms(lambda: cg(d, bt, tol=SOLVER_TOL))
    k8_ms = device_time(lambda: d.spmv(bt)).seconds * 1e3
    vec = 4 * n
    spmv_bytes = d.device_bytes() + 2 * vec
    # the loop body's vector passes: fused (x += a p, r -= a Ap, p = z + b p
    # at 3 vectors each, p.Ap 2, r.z and the test's r.r 1 each) and as the
    # torch ops run (each op reading its inputs once, writing its output)
    fused = spmv_bytes + 13 * vec
    written = spmv_bytes + 25 * vec
    hbm = detect_hbm_gbps() * 1e9
    # kernel time of 50 iterations under the profiler, against the same
    # iterations' event time without it (the profiler slows the host)
    _, busy = kernel_busy_ms(lambda: cg(d, bt, tol=0.0, maxiter=50))
    _, wall = timed_ms(lambda: cg(d, bt, tol=0.0, maxiter=50))
    us = ms * 1e3 / iters
    phase["cg"] = {
        "iters": iters, "iters_plain": i2["iters"], "iterate_rel": dz,
        "residual64": res, "ms": ms, "us_per_iter": us, "k8_us": k8_ms * 1e3,
        "bound_us_fused": fused / hbm * 1e6, "bytes_fused": fused,
        "bound_us_as_written": written / hbm * 1e6,
        "bytes_as_written": written,
        "iters50_ms": wall, "iters50_kernel_ms": busy,
        "outside_kernels_share": None if busy is None else 1 - busy / wall}
    print(f"16b cg(K8): {iters} iterations (plain version {i2['iters']}, "
          f"iterates {dz:.2e} apart), float64 residual {res:.3e}; "
          f"{ms:.2f} ms, {us:.2f} us/iteration; K8 call {k8_ms * 1e3:.2f} "
          f"us; iteration bound {fused / hbm * 1e6:.2f} us fused "
          f"({fused / 1e6:.2f} MB), {written / hbm * 1e6:.2f} us as written "
          f"({written / 1e6:.2f} MB); share outside kernels "
          + ("not measured" if busy is None else
             f"{1 - busy / wall:.3f} (50 iterations: {wall:.2f} ms, "
             f"{busy:.2f} ms of it in kernels)"))
    return iters


def solver_krylov(sp, d: DiaMatrix, bt, b, plain_iters: int, phase: dict):
    """16c: Lanczos bounds, Chebyshev CG, batched CG, BiCGStab, GMRES."""
    from tpusparse_torch.eig import spectrum_bounds
    from tpusparse_torch.solve import (bicgstab, cg, cg_multi,
                                       chebyshev_preconditioner, gmres)

    side = STENCIL[0]
    lam_max = 1e-3 + 4.0 + 4.0 * np.cos(np.pi / side)
    (lmin, lmax), _ = solver_counts(phase,
                                    lambda: spectrum_bounds(d, ncv=32))
    lmin, lmax = float(lmin), float(lmax)
    require(lam_max <= lmax <= 1.05 * lam_max,
            f"Lanczos lmax {lmax} vs the true {lam_max}")
    (zc, ic), _ = solver_counts(phase, lambda: cg(
        d, bt, tol=SOLVER_TOL, m_inv=chebyshev_preconditioner(d, lmax)))
    res_c = residual64(sp, zc, b)
    require(ic["iters"] < plain_iters and res_c <= 1e-4,
            f"Chebyshev CG: {ic['iters']} iterations (plain {plain_iters}), "
            f"residual {res_c:.3e}")
    _, cheb_ms = timed_ms(lambda: cg(
        d, bt, tol=SOLVER_TOL, m_inv=chebyshev_preconditioner(d, lmax)))
    bm = torch.from_numpy(generators.random_sparse_batch(
        4, d.shape[0], 0.5, 1)).to(bt.device)
    (zm, im), _ = solver_counts(phase,
                                lambda: cg_multi(d, bm, tol=SOLVER_TOL))
    singles = [cg(d, bm[i], tol=SOLVER_TOL) for i in range(4)]
    worst = max(rel(zm[i].cpu(), z.cpu()) for i, (z, _) in enumerate(singles))
    most = max(info["iters"] for _, info in singles)
    require(abs(im["iters"] - most) <= 1 and worst <= 1e-4,
            f"cg_multi: {im['iters']} iterations vs {most}, rows {worst:.3e} "
            "from the single solves")
    bn = float(torch.linalg.norm(bt))
    (_, ib), _ = solver_counts(phase,
                               lambda: bicgstab(d, bt, tol=SOLVER_TOL,
                                                maxiter=20))
    (_, ig), _ = solver_counts(phase,
                               lambda: gmres(d, bt, tol=SOLVER_TOL,
                                             restart=30, maxiter=30))
    rb, rg = float(ib["resnorm"]) / bn, float(ig["resnorm"]) / bn
    require(rb < 1.0 and rg < 1.0,
            f"bicgstab / gmres residuals did not fall: {rb:.3e}, {rg:.3e}")
    phase["krylov"] = {
        "lanczos_lmax": lmax, "lanczos_lmin": lmin, "true_lmax": lam_max,
        "lmax_over_true": lmax / lam_max, "cheb_iters": ic["iters"],
        "cheb_residual64": res_c, "cheb_ms": cheb_ms,
        "cg_multi_iters": im["iters"], "cg_single_max_iters": most,
        "cg_multi_row_rel": worst, "bicgstab_20_rel_resnorm": rb,
        "gmres_30_rel_resnorm": rg}
    print(f"16c Lanczos (ncv 32): lmax {lmax:.6f} = {lmax / lam_max:.4f} x "
          f"the true {lam_max:.6f}, lmin {lmin:.3e}; Chebyshev CG "
          f"{ic['iters']} iterations (plain {plain_iters}), residual "
          f"{res_c:.3e}, {cheb_ms:.2f} ms; cg_multi x4 {im['iters']} "
          f"iterations (single max {most}, rows {worst:.2e} apart); "
          f"bicgstab 20 its {rb:.3e}, gmres(30) {rg:.3e} of ||b||")


def solver_amg(host, sp, bt, b, dev, phase: dict) -> dict:
    """16d: the AMG hierarchy on the card: its levels, V-cycle and solve,
    each level's packs against the plain versions, save and load."""
    import tempfile

    from tpusparse_torch.amg import SmoothedAggregationAMG, from_host

    t0 = time.perf_counter()
    amg = from_host(*host, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    got = tuple((lv.n, lv.fmt) for lv in amg.levels)
    op_cx = f"{amg.operator_complexity:.2f}"
    print(f"16d {amg!r}")
    require(got == AMG_LEVELS and op_cx == AMG_OP_CX,
            f"AMG levels {got}, op_cx {op_cx}")
    require(all(isinstance(lv.p, RsellMatrix) and isinstance(lv.pt, RsellMatrix)
                for lv in amg.levels[:-1]), "carriers are not RSELL")
    _, per_cycle = solver_counts(phase, lambda: amg(bt))
    require(per_cycle["dia_spmv"] > 0 and per_cycle["rsell_spmv"] > 0
            and per_cycle["bsell_spmv"] + per_cycle["bsr_spmv"] > 0,
            f"V-cycle launches {per_cycle}")
    cyc_ms = statistics.median(timed_ms(lambda: amg(bt))[1]
                               for _ in range(20))
    (z, info), _ = solver_counts(phase,
                                 lambda: amg.solve(bt, tol=SOLVER_TOL))
    res = residual64(sp, z, b)
    require(res <= 1e-4 and float(info["resnorm"]) <= SOLVER_TOL
            * float(torch.linalg.norm(bt)) * 1.01,
            f"AMG solve: residual {res:.3e}, resnorm {float(info['resnorm'])}")
    solve_ms = statistics.median(
        timed_ms(lambda: amg.solve(bt, tol=SOLVER_TOL))[1] for _ in range(3))
    _, busy = kernel_busy_ms(lambda: amg(bt))
    # every pack of the path against its plain versions, timed; a V-cycle
    # applies each level's A 6 times (2 smoothers of degree 2, 2
    # residuals), its P and Pt once
    held = {}
    levels_h = host[0]
    for li, lv in enumerate(amg.levels[:-1]):
        h = levels_h[li]
        for name, pack, mat in (("A", lv.a, h.sp), ("P", lv.p, h.p),
                                ("Pt", lv.pt, h.p.T.tocsr())):
            if isinstance(pack, torch.Tensor):      # a dense level: no kernel
                continue
            row = hold_pack(f"L{li}.{name}", pack, mat, dev, seed=li,
                            timed=True)
            row["per_vcycle"] = 2 * amg.degree + 2 if name == "A" else 1
            held[f"L{li}.{name}"] = row
    gap = {k: sum(r["per_vcycle"] * (r["ms"] - r["bound_ms"]) * 1e3
                  for r in held.values() if k in r["kernels"])
           for k in SOLVER_WRAPPERS}
    # save, then load on the card (the same bits) and on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/amg.npz"
        t0 = time.perf_counter()
        amg.save(path)
        save_s = time.perf_counter() - t0
        back = SmoothedAggregationAMG.load(path, device=dev)
        z2, info2 = back.solve(bt, tol=SOLVER_TOL)
        require(info2["iters"] == info["iters"] and torch.equal(z2, z),
                "the loaded hierarchy does not solve bit for bit")
        cpu = SmoothedAggregationAMG.load(path, device="cpu")
        t0 = time.perf_counter()
        vc = cpu(bt.cpu())
        cpu_s = time.perf_counter() - t0
        dv = rel(vc, amg(bt).cpu())
    require(dv <= 1e-4, f"CPU V-cycle {dv:.3e} from the card's")
    phase["_amg"] = amg              # phase 18 times its V-cycle again
    phase["amg"] = {
        "repr": repr(amg), "host_setup_s": phase["amg_host_setup_s"],
        "pack_upload_s": pack_s, "vcycle_us": cyc_ms * 1e3,
        "vcycle_launches": per_cycle, "solve_iters": info["iters"],
        "solve_ms": solve_ms, "solve_residual64": res,
        "vcycle_kernel_us": None if busy is None else busy * 1e3,
        "outside_kernels_share": None if busy is None else 1 - busy / cyc_ms,
        "save_s": save_s, "cpu_vcycle_s": cpu_s, "cpu_vcycle_rel": dv,
        "vcycle_gap_us": gap, "packs": held}
    print(f"   host setup {phase['amg_host_setup_s']:.2f} s, pack + upload "
          f"{pack_s:.2f} s; V-cycle {cyc_ms * 1e3:.1f} us (median of 20), "
          f"launches "
          f"{json.dumps(per_cycle)}; solve {info['iters']} iterations, "
          f"{solve_ms:.2f} ms, float64 residual {res:.3e}; V-cycle share "
          "outside kernels " + ("not measured" if busy is None else
                                f"{1 - busy / cyc_ms:.3f} ({busy * 1e3:.1f} "
                                "us in kernels)")
          + f"; saved in {save_s:.1f} s, reloaded on the card: the same "
          f"bits; on the CPU V-cycle {cpu_s:.1f} s, "
          f"{dv:.2e} from the card's")
    return held


def solver_rcm(dev, phase: dict) -> None:
    """16e: a scrambled 1M-unknown chain, routed back to DIA by RCM, solved
    by CG in the permuted space against scipy's direct solve."""
    from scipy.sparse.linalg import spsolve

    from tpusparse_torch.reorder import (banded_after_rcm, permute_vector,
                                         unpermute_vector)
    from tpusparse_torch.solve import cg

    n = STENCIL[0] * STENCIL[1]
    chain = generators.stencil_csr((n,)).to_scipy().tocsr()
    q = np.random.default_rng(0).permutation(n)
    scrambled = chain[q][:, q].tocsr()
    t0 = time.perf_counter()
    got = banded_after_rcm(CsrMatrix.from_scipy(scrambled))
    rcm_s = time.perf_counter() - t0
    require(got is not None, "banded_after_rcm declined the scrambled chain")
    csr_b, p = got
    fmt = auto_format(csr_b)                             # device=None: GPU
    require(isinstance(fmt, DiaMatrix), f"RCM result packed as {fmt!r}")
    b = generators.random_sparse_vector(n, 0.5, 2)
    bt = torch.from_numpy(b).to(dev)
    (zb, info), _ = solver_counts(
        phase, lambda: cg(fmt, permute_vector(bt, p), tol=SOLVER_TOL))
    z = unpermute_vector(zb, p)
    t0 = time.perf_counter()
    z64 = spsolve(scrambled.astype(np.float64).tocsc(), b.astype(np.float64))
    direct_s = time.perf_counter() - t0
    dz = rel(z.cpu(), z64)
    require(dz <= 1e-4, f"RCM-space CG {dz:.3e} from the direct solve")
    phase["rcm"] = {"rcm_s": rcm_s, "format": repr(fmt),
                    "cg_iters": info["iters"], "rel_to_direct": dz,
                    "direct_s": direct_s}
    print(f"16e RCM on the scrambled chain: {rcm_s:.2f} s, {fmt!r}; CG in "
          f"the permuted space {info['iters']} iterations, {dz:.2e} from "
          f"scipy's direct solve ({direct_s:.2f} s)")


def solver_entry(dev, phase: dict) -> dict:
    """16f: the port's entry point on the card against the float64
    oracle, and K1 on its pack against the plain version, timed."""
    from scipy import sparse as ssp

    from tpusparse_torch.entry import DENSITY, M, N, SEED, entry

    fn, args = entry()
    y, _ = solver_counts(phase, lambda: fn(*args))
    a = generators.random_sparse_matrix(M, N, density=DENSITY, seed=SEED)
    e = max_err(y, reference.sgemv_cpu(args[1].cpu().numpy(), a))
    require(y.shape == (N,) and e <= ATOL, f"entry: |y-oracle| {e:.3e}")
    print(f"16f entry(): y {tuple(y.shape)}, |y-oracle| {e:.3e}")
    return hold_pack("entry", args[0], ssp.csr_matrix(a.astype(np.float64)),
                     dev, seed=SEED, timed=True)


def solver_path(csr, d: DiaMatrix, dev) -> dict:
    """Phase 16: the solver user's path on the 1M-unknown Laplacian."""
    t_phase = time.perf_counter()
    phase = {"launches": dict.fromkeys(SOLVER_WRAPPERS, 0)}
    sp = csr.to_scipy().tocsr().astype(np.float64)
    b = generators.random_sparse_vector(csr.shape[0], 0.5, 0)
    bt = torch.from_numpy(b).to(dev)
    host = solver_native(csr, phase)
    plain_iters = solver_cg(csr, sp, d, bt, b, phase)
    solver_krylov(sp, d, bt, b, plain_iters, phase)
    held = solver_amg(host, sp, bt, b, dev, phase)
    solver_rcm(dev, phase)
    held["entry"] = solver_entry(dev, phase)
    c = phase["launches"]
    for name in ("sell_spmv", "rsell_spmv", "dia_spmv"):
        require(c[name] > 0, f"{name}: no launch on the solver path")
    require(c["bsell_spmv"] + c["bsr_spmv"] > 0,
            "TCSR: no K6 or K7 launch on the solver path")
    phase["held"] = held
    phase["seconds"] = time.perf_counter() - t_phase
    print("launches on the solver path:", json.dumps(c),
          f"; phase 16 took {phase['seconds']:.1f} s")
    print(json.dumps({"solver_path": {k: v for k, v in phase.items()
                                      if k not in ("held", "_amg")}},
                     default=str))
    return phase


def solver_workload(phase: dict, name: str) -> dict:
    """A kernel's ``by_workload`` entry for the solver path: its launches
    there, its timed pack (if any) and the worst error over its packs."""
    rows = [r for r in phase["held"].values() if name in r["kernels"]]
    out = {"launches": phase["launches"][name],
           "max_abs_err": max((r["max_abs_err"] for r in rows), default=None),
           "packs_held": len(rows)}
    timed = [r for r in rows if "ms" in r]
    if timed:           # the largest of the kernel's shapes on this path
        big = max(timed, key=lambda r: r["bytes"])
        out.update({k: big[k] for k in ("shape", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
    if name == "dia_spmv":
        out["cg"] = phase["cg"]
    if name in ("rsell_spmv", "dia_spmv", "bsell_spmv", "bsr_spmv"):
        out["vcycle_launches"] = phase["amg"]["vcycle_launches"][name]
        out["vcycle_gap_us"] = phase["amg"]["vcycle_gap_us"][name]
    return out


# -- phase 17: the sharded path ------------------------------------------

SHARDED_WRAPPERS = {"sell_spmv": sell_spmm, "awsp_spmv": awsp_spmm,
                    "rsell_spmv": rsell_spmm, "permute": permute_columns,
                    "bsr_spmv": bsr_spmm, "bsell_spmv": bsell_spmm,
                    "dia_spmv": dia_spmv}
CHILD_WORLD = 2
CHILD_TIMEOUT = 600


def sharded_zero() -> None:
    for w in SHARDED_WRAPPERS.values():
        w.launches = 0
    dia_spmv.strip_launches = 0


def sharded_read() -> dict[str, int]:
    out = {name: w.launches for name, w in SHARDED_WRAPPERS.items()}
    out["dia_strips"] = dia_spmv.strip_launches
    return out


def require_sharded_launches(c: dict[str, int], where: str) -> None:
    """Every kernel of the sharded path launched, K8 with its strips."""
    for name in (*SHARDED_WRAPPERS, "dia_strips"):
        require(c[name] > 0, f"{where}: no {name} launch on the sharded "
                f"path ({json.dumps(c)})")


def ring_slabs(d: DiaMatrix, x: torch.Tensor, ranks: int):
    """The halo partition's slabs of (vals, x) at ``ranks`` ranks, on the
    JAX package's slab width, and each slab's strips as the ring hands
    them: the left neighbour's last hs x and vals, the right neighbour's
    first hs x (wrapping round), the vals strip zero on rank 0."""
    n, k = d.shape[1], len(d.offsets)
    hrows = halo_rows(d.offsets, d.sym)
    hs = hrows * 128
    rows = halo_slab_rows(k, hrows, n, ranks)
    nl = (n + (-n % (ranks * rows * 128))) // ranks
    xp = torch.nn.functional.pad(x, (0, ranks * nl - n))
    vp = torch.nn.functional.pad(d.vals, (0, ranks * nl - n))
    xs = [xp[r * nl:(r + 1) * nl] for r in range(ranks)]
    vs = [vp[:, r * nl:(r + 1) * nl].contiguous() for r in range(ranks)]
    out = []
    for r in range(ranks):
        left = (r - 1) % ranks
        strips = dict(
            xstrip_l=xs[left][-hs:].contiguous(),
            xstrip_r=xs[(r + 1) % ranks][:hs].contiguous(),
            vstrip=None if not d.sym else (
                torch.zeros((k, hs), device=x.device) if r == 0
                else vs[left][:, -hs:].contiguous()))
        out.append((vs[r], xs[r], nl, strips))
    return out, hs


def check_strips(dias: dict[str, DiaMatrix], dev) -> dict:
    """17a: K8 with halo strips, slab by slab, on each banded operator at
    D = 2 and 4: the slabs joined give the unsharded K8's bits, and each
    slab its plain version's. Returns the slab of the Laplacian at D = 2
    that is timed later."""
    timed = None
    for name, d in dias.items():
        n = d.shape[1]
        x = torch.from_numpy(generators.random_sparse_vector(n, 0.5, 0)) \
            .to(dev)
        want = d.spmv(x)
        for ranks in (2, 4):
            slabs, hs = ring_slabs(d, x, ranks)
            ys = []
            for r, (v, xs, nl, strips) in enumerate(slabs):
                y = dia_spmv(d.offsets, v, xs, sym=d.sym, n=nl, plan=d.plan,
                             **strips)
                yp = dia_spmv_plain(d.offsets, v, xs, sym=d.sym, n=nl,
                                    **strips)
                sync(dev)
                require(torch.equal(y, yp), f"K8 strips {name} D={ranks} "
                        f"slab {r}: not the plain version's bits")
                ys.append(y)
            require(torch.equal(torch.cat(ys)[:n], want),
                    f"K8 strips {name} D={ranks}: the joined slabs are not "
                    f"the unsharded K8's bits")
            print(f"   K8 strips, {name} at D={ranks}: {ranks} slabs of "
                  f"{slabs[0][2]} (hs {hs}), joined = unsharded K8 bit for "
                  f"bit, each slab = its plain version")
            if name == "laplace" and ranks == 2:
                timed = (d, slabs[1])
    return timed


def time_strip_body(timed, dev) -> dict:
    """K8's strip body on one slab (the Laplacian's rank 1 of 2), timed
    beside its plain version, its bound (the slab's vals, x, the three
    strips and y, each moved once) and K8 on the slab with no strips."""
    d, (v, xs, nl, strips) = timed
    hbm = detect_hbm_gbps() * 1e9

    def kern():
        return dia_spmv(d.offsets, v, xs, sym=d.sym, n=nl, plan=d.plan,
                        **strips)

    def plain():
        return dia_spmv_plain(d.offsets, v, xs, sym=d.sym, n=nl, **strips)

    nbytes = 4 * (v.numel() + 2 * nl + sum(t.numel() for t in
                                           strips.values()))
    ms = device_time(kern, name="dia_spmv strips").seconds * 1e3
    bare_ms = device_time(lambda: dia_spmv(d.offsets, v, xs, sym=d.sym, n=nl,
                                           plan=d.plan),
                          name="dia_spmv no strips").seconds * 1e3
    plain_ms = device_time(plain, name="dia_spmv strips plain", warmup=1,
                           reps=5).seconds * 1e3
    terms = len(d.offsets) + sum(1 for o in d.offsets if o > 0) * d.sym
    t_bytes = nbytes / hbm * 1e3
    t_ops = 2 * terms * nl / (FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_ops)
    require(bound / ms <= ARTIFACT_SHARE, f"K8 strips: share {bound / ms}")
    row = {"workload": f"laplace2d-1M slab 1 of 2 ({nl} outputs)",
           "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "bytes": nbytes, "share": bound / ms,
           "no_strips_ms": bare_ms}
    print(f"   K8 strip body on {row['workload']}: {ms * 1e3:.2f} us, bound "
          f"{bound * 1e3:.2f} us, share {bound / ms:.3f} | plain "
          f"{plain_ms * 1e3:.2f} us | the slab with no strips "
          f"{bare_ms * 1e3:.2f} us")
    return row


def public_calls(ops, packs, dias: dict[str, DiaMatrix], dev) -> dict:
    """The unsharded public call of each sharded case, on the card."""
    a_dev = torch.from_numpy(ops["a"]).to(dev)
    x, xb = (torch.from_numpy(ops[k]).to(dev) for k in ("x", "xb"))
    xs, xk = (torch.from_numpy(ops[k]).to(dev) for k in ("x_skew",
                                                         "x_blocky"))

    def sell_on(s):
        return SellMatrix(s.idx.to(dev), s.vals.to(dev), s.shape, s.padded,
                          s.w, s.nnz)

    sell, sell_rag = sell_on(packs["sell"]), sell_on(packs["sell_ragged"])
    h = packs["awsp"]
    awsp = AwspMatrix(h.idx.to(dev), h.vals.to(dev), h.shape, h.padded, h.w,
                      h.g, h.nnz)
    bsr = BsrMatrix.from_dense(ops["a"], device=dev)
    bm = packs["binned"]
    binned = BinnedSellMatrix([{k: v.to(dev) for k, v in bk.items()}
                               for bk in bm.buckets], bm.inv_perm,
                              bm.perm_plan, bm.shape, bm.nnz, bm.widths)
    rsell = RsellMatrix.from_dense(ops["a_skew"], device=dev)
    tcsr = TcsrMatrix.from_dense(ops["a_blocky"], device=dev)
    calls = {}
    for p in ("n", "m", "ring"):
        calls[f"dense[{p}]"] = lambda: dense_torch(a_dev, x)
        calls[f"sell[{p}]"] = lambda: sell.spmv(x)
        calls[f"bsr[{p}]"] = lambda: bsr.spmv(x)
        calls[f"awsp[{p}]"] = lambda: awsp.spmv(ops["x"])
    calls["sell[n ragged]"] = lambda: sell_rag.spmv(x)
    calls["sell[2d]"] = lambda: sell.spmm(xb)
    calls["bsr[2d]"] = lambda: bsr.spmm(xb)
    calls["binned[n]"] = lambda: binned.spmv(xs)
    for s in ("balance", "sorted"):
        calls[f"rsell[{s}]"] = lambda: rsell.spmv(xs)
    calls["tcsr[n]"] = lambda: tcsr.spmv(xk)
    dias = dict(dias)
    xds = {name: torch.from_numpy(ops["x_stencil"][name]).to(dev)
           for name in dias}
    if ops["band"] is not None:      # the small list's band of A
        dias["band"] = DiaMatrix.from_dense(ops["band"], device=dev)
        xds["band"] = x
    for name, d in dias.items():
        for p in ("halo", "n"):
            calls[f"dia[{p}] {name}"] = lambda d=d, xd=xds[name]: d.spmv(xd)
    return calls


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_world1(ops, host_dias, dias, dev) -> tuple[dict, dict, object]:
    """17b: the case list at world size 1 over NCCL (``initialize()`` in
    this process), counted; each case against the unsharded public call
    and the float64 oracle."""
    from tpusparse_torch.parallel import dryrun, initialize, make_mesh

    t0 = time.perf_counter()
    rank_dev = initialize(device=dev)
    require(torch.distributed.get_backend() == "nccl"
            and rank_dev.type == dev.type == "cuda",
            f"world 1: {torch.distributed.get_backend()} on {rank_dev}")
    mesh, mesh2 = make_mesh({"n": 1}), make_mesh({"b": 1, "n": 1})
    got = dryrun.collectives(mesh)
    for name, want in dryrun.expected_collectives(1, 0).items():
        require(np.array_equal(got[name].cpu().numpy(), want),
                f"world 1: comm {name} is wrong")
    packs = dryrun.host_packs(ops, 1, 1, dia=host_dias)
    t_pack = time.perf_counter() - t0
    calls = dryrun.sharded_calls(ops, packs, mesh, mesh2)
    for call in calls.values():      # first calls upload each rank's shard
        call()
    sync(dev)
    sharded_zero()
    got = {case: call() for case, call in calls.items()}
    sync(dev)
    counts = sharded_read()
    tally({k: v for k, v in counts.items() if k in ALL_WRAPPERS})
    require_sharded_launches(counts, "world 1 (NCCL)")
    public = public_calls(ops, packs, dias, dev)
    errs = {}
    for case, y in got.items():
        want = dryrun.oracle(ops, case)
        e_pub, e_ref = max_err(y, public[case]()), max_err(y, want)
        require(e_pub <= PLAIN_ATOL and e_ref <= ATOL,
                f"sharded {case} at world 1: |y-public| {e_pub:.3e}, "
                f"|y-oracle| {e_ref:.3e}")
        errs[case] = {"public": e_pub, "oracle": e_ref}
    print(f"-- phase 17b: {len(got)} sharded cases at world 1 over NCCL "
          f"(mesh {{'n': 1}}, 2d on {{'b': 1, 'n': 1}}; host packs "
          f"{t_pack:.1f} s): every case within {PLAIN_ATOL} of its unsharded "
          f"public call and {ATOL} of the oracle (worst "
          f"{max(e['oracle'] for e in errs.values()):.2e}); launches "
          f"{json.dumps(counts)}")
    host = {case: y.cpu().numpy() for case, y in got.items()}
    return host, counts, mesh


def spawn_children(out_dir, size: str, dev) -> list:
    """17c: start the world of CHILD_WORLD ranks over gloo on this card
    (this script with ``--sharded-rank``)."""
    import os
    import socket
    import subprocess

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
         str(CHILD_WORLD), str(port), str(out_dir), size, str(dev)],
        cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(CHILD_WORLD)]


def sharded_child(rank: int, world: int, port: int, out_dir: str,
                  size: str = "full", device: str = "cuda:0") -> int:
    """One rank of 17c: the case list (``dryrun``'s ``size``) and a CG
    through the halo partition, over gloo on ``device``; results to
    ``out_dir/rank<r>.npz`` and ``.json``."""
    import os

    from tpusparse_torch.parallel import (comm, dryrun, initialize,
                                          make_mesh)
    from tpusparse_torch.parallel.sparse import dia_spmm_sharded
    from tpusparse_torch.solve import cg

    t0 = time.perf_counter()
    dev = initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     device=device)
    mesh = make_mesh({"n": world})
    mesh2 = make_mesh({"b": world, "n": 1})
    ops = dryrun.operands(size, world)
    packs = dryrun.host_packs(ops, world, 1)
    t_pack = time.perf_counter() - t0
    calls = dryrun.sharded_calls(ops, packs, mesh, mesh2)
    got = dryrun.collectives(mesh)
    for name, want in dryrun.expected_collectives(world, rank).items():
        if not np.array_equal(got[name].cpu().numpy(), want):
            raise SmokeFailure(f"rank {rank}: comm {name} is wrong")
    sharded_zero()
    res = {case: call().cpu().numpy() for case, call in calls.items()}
    sync(dev)
    counts = sharded_read()
    dm = packs["dia"]["laplace"]
    b = torch.from_numpy(generators.random_sparse_vector(dm.shape[0], 0.5, 0)
                         ).to(dev)
    t1 = time.perf_counter()
    z, info = cg(lambda v: dia_spmm_sharded(dm, v, mesh, "halo"), b,
                 tol=SOLVER_TOL)
    t_cg = time.perf_counter() - t1
    res["cg_z"] = z.cpu().numpy()
    t2 = time.perf_counter()              # 18d: the train step, both AMGs
    p18_zero()
    solved = dryrun.solver_cases(p18_child_operands(ops, world), mesh)
    sync(dev)
    c18 = p18_read()
    levels = [solved.pop(k) for k in ("grid_levels", "greedy_levels")]
    for k in ("train_vals", "train_vals_t", "train_drift"):
        solved.pop(k)
    res.update({f"p18:{k}": np.asarray(v) for k, v in solved.items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "device": str(dev), "counts": counts,
                   "transport": comm.transport(mesh.get_group("n"), dev),
                   "cg_iters": int(info["iters"]), "cg_s": t_cg,
                   "pack_s": t_pack, "p18_counts": c18,
                   "p18_levels": levels, "p18_s": time.perf_counter() - t2,
                   "s": time.perf_counter() - t0}, f)
    torch.distributed.destroy_process_group()
    return 0


def join_children(procs, out_dir, world1: dict, cg_ref,
                  p18_ref: dict) -> dict:
    """17c's check: every child ended well; its cases within 1e-3 of the
    oracle and 1e-4 of world 1's; both ranks the same y; the sharded CG
    took the unsharded K8 CG's iterations and gave its bits. 18d's: the
    train step and both AMG solves the same bits on both ranks, each AMG
    in world 1's iterations (``p18_ref``), the loss falling, and K1, K10
    and K4 launched."""
    import os

    from tpusparse_torch.parallel import dryrun

    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"sharded rank {r} of {CHILD_WORLD} "
                f"failed (exit {p.returncode}):\n{log[-4000:]}")
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(CHILD_WORLD)]
    info = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in range(CHILD_WORLD)]
    ops = world1["ops"]
    errs = {}
    for case, y1 in world1["y"].items():
        y = ranks[0][case]
        for r in range(1, CHILD_WORLD):
            require(np.array_equal(ranks[r][case], y),
                    f"world {CHILD_WORLD}: {case} differs on rank {r}")
        e_ref = float(np.abs(y.astype(np.float64)
                             - dryrun.oracle(ops, case)).max())
        e_w1 = float(np.abs(y.astype(np.float64) - y1).max())
        require(e_ref <= ATOL and e_w1 <= PLAIN_ATOL,
                f"sharded {case} at world {CHILD_WORLD}: |y-oracle| "
                f"{e_ref:.3e}, |y-world1| {e_w1:.3e}")
        errs[case] = {"oracle": e_ref, "world1": e_w1}
    z_ref, iters_ref = cg_ref
    for r, inf in enumerate(info):
        require_sharded_launches(inf["counts"],
                                 f"world {CHILD_WORLD} rank {r}")
        require(inf["transport"] == "gloo via host",
                f"rank {r} transport {inf['transport']}")
        require(inf["cg_iters"] == iters_ref
                and np.array_equal(ranks[r]["cg_z"], z_ref),
                f"sharded CG on rank {r}: {inf['cg_iters']} iterations "
                f"against the unsharded K8 CG's {iters_ref}, or other bits")
    for k in ranks[0]:
        if k.startswith("p18:"):
            for r in range(1, CHILD_WORLD):
                require(np.array_equal(ranks[r][k], ranks[0][k]),
                        f"18d: {k} differs on rank {r}")
    loss = ranks[0]["p18:train_loss"]
    iters18 = {k: int(ranks[0][f"p18:{k}"])
               for k in ("grid_iters", "greedy_iters")}
    require(iters18 == {k: p18_ref[k] for k in iters18},
            f"18d: AMG iterations {iters18}, world 1 took "
            f"{ {k: p18_ref[k] for k in iters18} }")
    require(loss[1] < loss[0], f"18d: the loss did not fall: {loss}")
    for r, inf in enumerate(info):
        c = inf["p18_counts"]
        require(c["sell_spmv"] > 0 and c["sell_grad"] > 0
                and c["rsell_spmv"] > 0, f"18d rank {r}: launches {c}")
    print(f"-- phase 18d: the same {CHILD_WORLD} gloo ranks: the train "
          f"step at the headline, B = 8 (losses {loss.tolist()}), and both "
          f"AMG solves at the dry run's small sizes (levels "
          f"{info[0]['p18_levels']}; iterations {iters18}, world 1's): "
          f"the same bits on both ranks; launches "
          f"{json.dumps([i['p18_counts'] for i in info])}; ranks took "
          f"{[round(i['p18_s'], 1) for i in info]} s")
    print(f"-- phase 17c: a world of {CHILD_WORLD} ranks on this card, "
          f"transport: {info[0]['transport']}; {len(errs)} cases within "
          f"{ATOL} of the oracle (worst "
          f"{max(e['oracle'] for e in errs.values()):.2e}) and {PLAIN_ATOL} "
          f"of world 1 (worst {max(e['world1'] for e in errs.values()):.2e})"
          f"; sharded CG (halo, K8 with strips): {info[0]['cg_iters']} "
          f"iterations, the unsharded K8 CG's bits; ranks took "
          f"{[round(i['s'], 1) for i in info]} s (host packs "
          f"{[round(i['pack_s'], 1) for i in info]} s, CG "
          f"{[round(i['cg_s'], 2) for i in info]} s); launches "
          f"{json.dumps([i['counts'] for i in info])}")
    return {"errs": errs, "ranks": info}


def sharded_path(d_lap: DiaMatrix, dev, size: str = "full",
                 solver: dict | None = None, train=None) -> dict:
    """Phase 17: the sharded serving path (``tpusparse_torch.parallel``) on
    ``dryrun``'s ``size`` operands; then phase 18 (sharded training and
    AMG) in the same world of one rank, its 18d riding 17c's children."""
    import tempfile

    from tpusparse_torch.bench import shard_overhead
    from tpusparse_torch.parallel import dryrun
    from tpusparse_torch.solve import cg

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = spawn_children(out_dir, size, dev)  # they pack meanwhile
        try:
            ops = dryrun.operands(size, CHILD_WORLD)   # the children's
            host_dias = {name: DiaMatrix.from_csr(c, device="cpu")
                         for name, c in ops["stencils"].items()}
            dias = {name: DiaMatrix(h.offsets, h.vals.to(dev), h.shape,
                                    h.nnz, sym=h.sym)
                    for name, h in host_dias.items()}
            print("-- phase 17a: K8 with halo strips, slab by slab")
            timed = check_strips(dias, dev)
            y1, c1, mesh = sharded_world1(ops, host_dias, dias, dev)
            b = torch.from_numpy(generators.random_sparse_vector(
                d_lap.shape[0], 0.5, 0)).to(dev)
            z, info = cg(d_lap, b, tol=SOLVER_TOL)
            t18 = time.perf_counter()
            p18 = phase18(mesh, d_lap, solver, train, dev)
            p18_ref = p18_child_reference(mesh, ops)
            t18 = time.perf_counter() - t18
            c2 = join_children(procs, out_dir, {"ops": ops, "y": y1},
                               (z.cpu().numpy(), int(info["iters"])),
                               p18_ref)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    strip_row = time_strip_body(timed, dev)
    card = card_info()["line"]
    over = shard_overhead.run(mesh, verbose=False)
    print(f"-- phase 17b: the sharded call at world size 1 (NCCL) against the "
          f"unsharded public call, {card}: " + "; ".join(
              f"{k} {over[k]['sharded_us']:.2f} us sharded / "
              f"{over[k]['unsharded_us']:.2f} us unsharded = "
              f"{over[k]['ratio']:.3f} (back to back "
              f"{over[k]['sharded_call_us']:.1f} / "
              f"{over[k]['unsharded_call_us']:.1f} us = "
              f"{over[k]['call_ratio']:.2f})" for k in ("sell", "dia", "tcsr")))
    t0 = time.perf_counter()
    p18["times"] = phase18_times(p18.pop("timed"), solver, card)
    p18["seconds"] = t18 + time.perf_counter() - t0
    print(f"   phase 18 took {p18['seconds']:.1f} s (18d in 17c's children)")
    phase = {"world1_launches": c1, "world2": c2["ranks"],
             "cg_iters": int(info["iters"]), "strip_body": strip_row,
             "shard_overhead": over,
             "seconds": time.perf_counter() - t_phase - p18["seconds"]}
    print(f"   phase 17 took {phase['seconds']:.1f} s")
    print(json.dumps({"sharded_path": phase}))
    print(json.dumps({"phase18": p18}))
    phase["phase18"] = p18
    torch.distributed.destroy_process_group()
    return phase


# -- phase 18: sharded training and AMG -----------------------------------

P18_WRAPPERS = {"sell_spmv": sell_spmm, "sell_grad": sell_dvals,
                "rsell_spmv": rsell_spmm, "dia_spmv": dia_spmv}
P18_LIMIT = 1e-5       # sharded at world 1 against unsharded (bits expected)


def p18_zero() -> None:
    for w in P18_WRAPPERS.values():
        w.launches = 0
    dia_spmv.strip_launches = 0


def p18_read() -> dict[str, int]:
    out = {name: w.launches for name, w in P18_WRAPPERS.items()}
    out["dia_strips"] = dia_spmv.strip_launches
    return out


def p18_counted(launches: dict, fn):
    """Run ``fn`` with phase 18's counters at 0; add its launches to
    ``launches`` and to TOTALS; return its result and those launches."""
    torch.cuda.synchronize()
    p18_zero()
    out = fn()
    torch.cuda.synchronize()
    c = p18_read()
    tally({k: v for k, v in c.items() if k in ALL_WRAPPERS})
    for k, v in c.items():
        launches[k] = launches.get(k, 0) + v
    return out, c


def p18_child_operands(ops: dict, world: int) -> dict:
    """18d's operands: both AMG cases at the dry run's small sizes, the
    train step at the headline with B = 8 (the full list's ``a``, ``xb``)."""
    from tpusparse_torch.parallel import dryrun

    sops = dryrun.solver_operands("small", dryrun.operands("small", world))
    sops.update(a_train=ops["a"], x_train=ops["xb"])
    return sops


def p18_child_reference(mesh, ops: dict) -> dict:
    """18d's cases at world 1 (this process), for their AMG iterations."""
    from tpusparse_torch.parallel import dryrun

    got = dryrun.solver_cases(p18_child_operands(ops, CHILD_WORLD), mesh,
                              train=False)
    return {k: int(got[k]) for k in ("grid_iters", "greedy_iters")}


def _fwd_bwd(apply, params, x, g):
    y = apply(params, x)
    y.backward(g)
    return y.detach()


def p18_training(mesh, train, dev, launches: dict) -> tuple[dict, dict]:
    """18a: ``trainable_linear_sharded`` at world 1 over NCCL on the
    headline matrix, against phase 11's unsharded ``trainable_linear``."""
    from tpusparse_torch import trainable_linear_sharded
    from tpusparse_torch.parallel import dryrun

    csr, a, apply1, params1, resync1 = train
    m, n = csr.shape
    t0 = time.perf_counter()
    aps, ps, masks, resyncs = trainable_linear_sharded(csr, mesh)
    torch.cuda.synchronize()
    rec = {"twin_pack_s": time.perf_counter() - t0, "by_batch": {}}
    require(all(ps[k].shape == params1[k].shape
                and int(masks[k].sum()) == csr.nnz for k in ps),
            "18a: at one rank the shards are the whole twin layouts")
    a64 = torch.from_numpy(a).to(dev).double()
    for batch in BATCHES:
        x = generators.random_sparse_batch(batch, m, 0.5, seed=batch)
        g = np.random.default_rng(batch).uniform(-1, 1, (batch, n)) \
            .astype(np.float32)
        if batch == 1:
            x, g = x[0], g[0]
        xs, x1 = (torch.from_numpy(x).to(dev).requires_grad_()
                  for _ in range(2))
        gt = torch.from_numpy(g).to(dev)
        for p in (*ps.values(), *params1.values()):
            p.grad = None
        y, c = p18_counted(launches, lambda: _fwd_bwd(aps, ps, xs, gt))
        require(c["sell_spmv"] == 2 and c["sell_grad"] == 2,
                f"18a B={batch}: K1 x2 and K10 x2 expected, got {c}")
        y1 = _fwd_bwd(apply1, params1, x1, gt)
        pairs = {"y": (y, y1), "dx": (xs.grad, x1.grad),
                 "dvals": (ps["vals"].grad, params1["vals"].grad),
                 "dvals_t": (ps["vals_t"].grad, params1["vals_t"].grad)}
        diff = {k: float((u - v).abs().max()) for k, (u, v) in pairs.items()}
        bits = all(torch.equal(u, v) for u, v in pairs.values())
        x64 = xs.detach().double().reshape(-1, m)
        g64 = gt.double().reshape(-1, n)
        e_y = max_err(y.reshape(-1, n), x64 @ a64)
        e_dx = max_err(xs.grad.reshape(-1, m), g64 @ a64.T)
        require(max(diff.values()) <= P18_LIMIT,
                f"18a B={batch}: sharded against unsharded {diff}")
        require(max(e_y, e_dx) <= ATOL,
                f"18a B={batch}: |y-oracle| {e_y:.3e} |dx-oracle| {e_dx:.3e}")
        rec["by_batch"][str(batch)] = {"bits": bits, "diff": diff,
                                       "y_oracle": e_y, "dx_oracle": e_dx,
                                       "launches": c}
        print(f"   18a B={batch}: sharded vs unsharded y, dx, dvals, dvals_t "
              f"{'the same bits' if bits else json.dumps(diff)}; |y-oracle| "
              f"{e_y:.2e}, |dx-oracle| {e_dx:.2e}; launches {json.dumps(c)}")
    # two SGD steps on the weights and the activations (the dry run's)
    x = torch.from_numpy(generators.random_sparse_batch(8, m, 0.5, seed=21)) \
        .to(dev)
    losses = []
    for _ in range(2):
        xr = x.clone().requires_grad_()

        def step():
            loss = (aps(ps, xr) ** 2).sum() / n
            loss.backward()
            return loss.detach()

        loss, c = p18_counted(launches, step)
        require(c["sell_spmv"] == 2 and c["sell_grad"] == 2,
                f"18a step: K1 x2 and K10 x2 expected, got {c}")
        with torch.no_grad():
            for p in ps.values():
                p -= dryrun.TRAIN_LR * p.grad
                p.grad = None
            x = x - dryrun.X_LR * xr.grad
        losses.append(float(loss))
    require(losses[1] < losses[0], f"18a: the loss did not fall: {losses}")
    before = ps["vals_t"].detach().clone()
    resyncs(ps)
    tied = {"vals": ps["vals"], "vals_t": before.clone()}
    resync1(tied)                  # the unsharded re-tie of the same vals
    exact = torch.equal(ps["vals_t"], tied["vals_t"])
    require(exact, "18a: the sharded resync is not the unsharded re-tie")
    rec.update(losses=losses, resync_exact=exact,
               drift=float((before - ps["vals_t"].detach()).abs().max()))
    print(f"-- phase 18a: trainable_linear_sharded at world 1 (NCCL), "
          f"{m}x{n}: twin pack + shards {rec['twin_pack_s']:.1f} s; SGD "
          f"losses {losses}; resync exact, drift before it {rec['drift']}")
    return rec, {"aps": aps, "ps": ps, "apply1": apply1, "params1": params1,
                 "m": m, "n": n}


def p18_amg(mesh, d_lap: DiaMatrix, solver: dict, dev,
            launches: dict) -> tuple[dict, dict]:
    """18b and 18c: grid AMG placed with ``shard`` and greedy AMG built
    with ``mesh=``, at world 1 on the 1M-unknown Laplacian, against the
    unsharded builds (phase 16's for greedy)."""
    from tpusparse_torch.amg import smoothed_aggregation

    lap = generators.stencil_csr(STENCIL)
    sp = lap.to_scipy().tocsr().astype(np.float64)
    b = generators.random_sparse_vector(lap.shape[0], 0.5, 0)   # phase 16's
    bt = torch.from_numpy(b).to(dev)
    t0 = time.perf_counter()
    grid0 = smoothed_aggregation(lap, aggregation="grid", device=dev)
    grid = grid0.shard(mesh)
    torch.cuda.synchronize()
    setup_b = time.perf_counter() - t0
    ops_b = [type(lv.a).__name__ for lv in grid.levels]
    require(ops_b[0] == "_HaloDia", f"18b: level 0 is {ops_b[0]}")
    z0, i0 = grid0.solve(bt, tol=SOLVER_TOL)
    (z, info), c = p18_counted(launches,
                               lambda: grid.solve(bt, tol=SOLVER_TOL))
    dz = max_err(z, z0)
    res = residual64(sp, z, b)
    require(c["dia_strips"] > 0 and c["dia_spmv"] > 0,
            f"18b: K8's strip kernel did not run: {c}")
    require(int(info["iters"]) == int(i0["iters"]) and dz <= P18_LIMIT
            and res <= ATOL, f"18b: {info['iters']} iterations against "
            f"{i0['iters']}, |z-z0| {dz:.3e}, residual {res:.3e}")
    rec_b = {"levels": repr(grid0), "ops": ops_b, "setup_s": setup_b,
             "iters": int(info["iters"]), "dz": dz, "bits": bool(
                 torch.equal(z, z0)), "residual64": res, "launches": c}
    print(f"-- phase 18b: grid AMG placed with shard(mesh) at world 1: "
          f"{ops_b}; CG {info['iters']} iterations (unsharded "
          f"{i0['iters']}), |z-z0| {dz:.2e}, residual {res:.2e}; setup "
          f"{setup_b:.1f} s; launches {json.dumps(c)}")
    t0 = time.perf_counter()
    greedy = smoothed_aggregation(lap, mesh=mesh)
    torch.cuda.synchronize()
    setup_c = time.perf_counter() - t0
    fmts = [lv.fmt for lv in greedy.levels]
    require(all(f == "rsell-shard" for f in fmts[:-1]),
            f"18c: levels {fmts}")
    (zg, ig), c = p18_counted(launches,
                              lambda: greedy.solve(bt, tol=SOLVER_TOL))
    res_g = residual64(sp, zg, b)
    iters16 = int(solver["amg"]["solve_iters"])
    res16 = float(solver["amg"]["solve_residual64"])
    require(c["rsell_spmv"] > 0, f"18c: no K4 launch: {c}")
    require(int(ig["iters"]) == iters16
            and res_g <= max(2 * res16, SOLVER_TOL),
            f"18c: {ig['iters']} iterations (phase 16: {iters16}), residual "
            f"{res_g:.3e} (phase 16: {res16:.3e})")
    rec_c = {"levels": repr(greedy), "setup_s": setup_c,
             "iters": int(ig["iters"]), "residual64": res_g,
             "phase16_iters": iters16, "phase16_residual64": res16,
             "launches": c}
    print(f"-- phase 18c: smoothed_aggregation(lap, mesh=mesh) at world 1: "
          f"{fmts}; CG {ig['iters']} iterations (phase 16: {iters16}), "
          f"residual {res_g:.2e} (phase 16: {res16:.2e}); setup "
          f"{setup_c:.1f} s; launches {json.dumps(c)}")
    return {"grid": rec_b, "greedy": rec_c}, {
        "grid": grid, "grid0": grid0, "greedy": greedy, "bt": bt}


def phase18(mesh, d_lap, solver, train, dev) -> dict:
    """Phase 18a-c in this process's world of one rank (NCCL): correctness
    and launches; their times wait until 17c's children have ended."""
    launches: dict[str, int] = {}
    train_rec, t_objs = p18_training(mesh, train, dev, launches)
    amg_rec, a_objs = p18_amg(mesh, d_lap, solver, dev, launches)
    for name in ("sell_spmv", "sell_grad", "rsell_spmv", "dia_strips"):
        require(launches.get(name, 0) > 0, f"phase 18: no {name} launch")
    return {"train": train_rec, "amg": amg_rec, "launches": launches,
            "timed": {**t_objs, **a_objs}}


def phase18_times(o: dict, solver: dict, card: str) -> dict:
    """A sharded training step (fwd + bwd) beside the unsharded one at B = 1
    and 8, and each AMG's V-cycle beside its unsharded one (phase 16's
    hierarchy for greedy), alone on the card; each pair in turns, sharded
    first and last (host time drifts within a call)."""
    from tpusparse_torch.bench.shard_overhead import SPIN

    out = {"card": card}
    m, n, dev = o["m"], o["n"], o["bt"].device
    for batch in BATCHES:
        x = torch.from_numpy(generators.random_sparse_batch(
            batch, m, 0.5, seed=30 + batch)).to(dev).requires_grad_()
        g = torch.from_numpy(np.random.default_rng(31).uniform(
            -1, 1, (batch, n)).astype(np.float32)).to(dev)
        runs = {"sharded": [], "unsharded": []}
        for name in ("sharded", "unsharded", "unsharded", "sharded"):
            ap, ps = (o["aps"], o["ps"]) if name == "sharded" else \
                (o["apply1"], o["params1"])
            runs[name].append(device_time(
                lambda: torch.autograd.grad(ap(ps, x), [ps["vals"],
                                                        ps["vals_t"], x], g),
                name=f"step {name}", spin=SPIN).seconds * 1e6)
        us = {k: statistics.mean(v) for k, v in runs.items()}
        us["ratio"] = us["sharded"] / us["unsharded"]
        us["turns"] = runs           # A B B A: host time drifts in a call
        out[f"step_B{batch}_us"] = us
    bt = o["bt"]
    pairs = {"grid": (o["grid"], o["grid0"]),
             "greedy": (o["greedy"], solver["_amg"])}  # phase 16's own
    for case, (sharded, unsharded) in pairs.items():
        runs = {"sharded": [], "unsharded": []}
        for name in ("sharded", "unsharded", "unsharded", "sharded"):
            amg = sharded if name == "sharded" else unsharded
            runs[name].append(statistics.median(
                timed_ms(lambda: amg(bt))[1] for _ in range(20)) * 1e3)
        out[f"vcycle_{case}_us"] = {k: statistics.mean(v)
                                    for k, v in runs.items()}
        out[f"vcycle_{case}_us"]["turns"] = runs
    out["vcycle_phase16_us"] = solver["amg"]["vcycle_us"]
    print(f"-- phase 18 times, {card}: training step (fwd+bwd) "
          + "; ".join(f"B={b} sharded {out[f'step_B{b}_us']['sharded']:.2f} "
                      f"us / unsharded "
                      f"{out[f'step_B{b}_us']['unsharded']:.2f} us = "
                      f"{out[f'step_B{b}_us']['ratio']:.3f}" for b in BATCHES)
          + "; V-cycle (medians of 20, in turns) " + "; ".join(
              f"{c} sharded {out[f'vcycle_{c}_us']['sharded']:.1f} us / "
              f"unsharded {out[f'vcycle_{c}_us']['unsharded']:.1f} us"
              for c in ("grid", "greedy"))
          + f" (phase 16 timed its own {out['vcycle_phase16_us']:.1f} us)")
    return out


# -- phase 19: the gallery, dynamic serving, GB scale, the CLI, examples ---

# the kernels each counted part of phase 19 must launch
P19_NEED = {
    "gallery": ("sell_spmv", "permute", "rsell_spmv", "bsell_spmv",
                "bsr_spmv", "dia_spmv", "asp_spmv"),
    "dynamic": ("awsp_spmv", "group_plan", "asp_spmv"),
    "scale": ("rsell_spmv",),
    "examples": ("sell_spmv", "awsp_spmv", "group_plan", "rsell_spmv",
                 "sell_grad", "dia_spmv"),
}
# the GB-scale point of tpusparse/bench/scale.py's docstring (~28 M nnz)
SCALE_POINT = dict(m=65536, density=0.02)
MESH_MTX = "data/fem_mesh_16384.mtx"
CLI_RUNS = (("check",), ("mtx", MESH_MTX),
            ("solve", "--file", MESH_MTX, "--precond", "amg"),
            ("report", "--sections", "canonical"))


def p19_counted(part: str, launches: dict, fn):
    """Run ``fn`` with every counter at 0; add its launches to ``TOTALS``
    and ``launches[part]``; require the part's kernels."""
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    c = read_counts(ALL_WRAPPERS)
    tally(c)
    launches[part] = c
    print(f"   19 {part}: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps({k: v for k, v in c.items() if v})}")
    for name in P19_NEED[part]:
        require(c[name] > 0, f"phase 19 {part}: no {name} launch")
    return out


def p19_gallery(dev) -> dict:
    """19a: the 13 gallery workloads at B = 1, every candidate held to the
    float64 oracle (1e-3) and timed, no share above the artifact limit
    (``run_workload`` raises otherwise)."""
    from tpusparse_torch.bench import gallery

    out = {}
    for name in gallery.WORKLOADS:
        r = gallery.run_workload(name, batch=1, device=dev, verbose=False)
        out[name] = {"routed": r["routed"], "best": r["best"],
                     "regret_pct": r["regret_pct"], "rows": {
                         k: {"us": v["us"], "share": v["roofline"],
                             "pack_s": v["pack_s"],
                             "upload_s": v.get("upload_s"),
                             "max_abs_err": v.get("max_abs_err"),
                             "skipped": v.get("skipped")}
                         for k, v in r["rows"].items()}}
    print(json.dumps({"gallery": out}))
    return out


def p19_dynamic(dev) -> dict:
    """19b: AWSP's serving variants at the JAX defaults (4096^2, d = 0.5,
    g = 2, live 1/4, 5 patterns) at B = 1 and 8, and ASP's at B = 1; each
    pattern checked (dynamic and static the same bits, all within 1e-3)."""
    from tpusparse_torch.bench import dynamic

    out = {"awsp": dynamic.run_awsp(verbose=False, device=dev),
           "awsp_b8": dynamic.run_awsp(batch=8, verbose=False, device=dev),
           "asp": dynamic.run_asp(verbose=False, device=dev)}
    print(json.dumps({"dynamic": out}))
    return out


def p19_scale(dev) -> dict:
    """19c: the GB-scale run at 65536^2, d = 0.02, with its train step."""
    from tpusparse_torch.bench import scale

    rec = scale.run(**SCALE_POINT, device=dev, verbose=False)
    print(json.dumps({"scale": rec}))
    require("cliff" not in rec, f"phase 19c: cliff at {SCALE_POINT}")
    # the step runs at this point: a gate here is a failure, not a result
    require("train_us" in rec, f"phase 19c: the train step did not run "
            f"({rec.get('train_gate')})")
    require(rec["train_y_err"] <= 1e-3 and rec["train_grad_err"] <= 1e-3,
            f"phase 19c: the train step's y {rec['train_y_err']} or value "
            f"gradients {rec['train_grad_err']} off the oracle")
    return rec


def p19_cli() -> dict:
    """19d: the command line in subprocesses: ``check`` (the full
    registry), ``mtx`` and ``solve --precond amg`` on the repo's FEM mesh,
    and the report's canonical section."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for args in CLI_RUNS:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "tpusparse_torch", *args],
                           cwd=root, capture_output=True, text=True,
                           timeout=600)
        text = r.stdout
        require(r.returncode == 0, f"phase 19d: {' '.join(args)} exited "
                f"{r.returncode}:\n{text[-2000:]}\n{r.stderr[-2000:]}")
        ok = {"check": text.count(" OK") == len(registry(full=True)),
              "mtx": "(OK)" in text, "solve": "[OK]" in text,
              "report": "## Canonical" in text}[args[0]]
        require(ok, f"phase 19d: {' '.join(args)} did not pass:\n{text}")
        out[" ".join(args)] = {"seconds": time.perf_counter() - t0,
                               "stdout": text.strip().splitlines()[-24:]}
        print(f"   $ python -m tpusparse_torch {' '.join(args)}  "
              f"({out[' '.join(args)]['seconds']:.1f} s)")
        for line in out[" ".join(args)]["stdout"]:
            print(f"     {line}")
    return out


def p19_examples(dev) -> dict:
    """19e: the 13 examples in this process on the card, each through its
    ``main()`` with its own checks."""
    import importlib
    import pkgutil

    import tpusparse_torch.examples as ex

    out = {}
    for m in sorted(pkgutil.iter_modules(ex.__path__), key=lambda m: m.name):
        out[m.name] = importlib.import_module(
            f"tpusparse_torch.examples.{m.name}").main(device=dev)
    require(len(out) == 13, f"{len(out)} examples, want 13")
    print(json.dumps({"examples": out}, default=float))
    return out


def phase19(dev) -> dict:
    t0 = time.perf_counter()
    launches: dict[str, dict] = {}
    if dev.type == "cuda":
        print(f"-- phase 19: {torch.cuda.memory_allocated() / 1e9:.2f} GB of "
              f"device memory held by the earlier phases")
    print("-- phase 19a: the gallery's 13 workloads at B = 1")
    p19_counted("gallery", launches, lambda: p19_gallery(dev))
    print("-- phase 19b: dynamic serving (AWSP B = 1, 8; ASP)")
    p19_counted("dynamic", launches, lambda: p19_dynamic(dev))
    print(f"-- phase 19c: GB scale at {SCALE_POINT}")
    p19_counted("scale", launches, lambda: p19_scale(dev))
    for name in ("sell_spmv", "sell_grad"):
        require(launches["scale"][name] > 0,
                f"phase 19c: the train step launched no {name}")
    print("-- phase 19d: the command line")
    cli = p19_cli()
    print("-- phase 19e: the 13 examples")
    p19_counted("examples", launches, lambda: p19_examples(dev))
    seconds = time.perf_counter() - t0
    print(f"   phase 19 took {seconds:.1f} s")
    return {"launches": launches, "cli_seconds": {
        k: v["seconds"] for k, v in cli.items()}, "seconds": seconds}


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
    check_dia(banded_results, d, x1_d, dev)
    dia27 = stencil27(dev)
    check_block_extras(a_b, x8_b, dev)

    csr_a = CsrMatrix.from_dense(a)
    apply, params, k10, resync = training_path(csr_a, a, dev)
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
    solver = solver_path(csr, d, dev)
    sharded = sharded_path(d, dev, solver=solver,
                           train=(csr_a, a, apply, params, resync))

    p19 = phase19(dev)

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
        row["phase19_launches"] = {part: c[row["name"]]
                                   for part, c in p19["launches"].items()}
        if row["name"] in SHARDED_WRAPPERS:
            row["sharded_launches"] = {
                "world1_nccl": sharded["world1_launches"][row["name"]],
                "world2_gloo": [r["counts"][row["name"]]
                                for r in sharded["world2"]]}
        if row["name"] in P18_WRAPPERS:
            p18 = sharded["phase18"]
            row["phase18_launches"] = {
                "world1_nccl": p18["launches"].get(row["name"], 0),
                "world2_gloo": [r["p18_counts"][row["name"]]
                                for r in sharded["world2"]]}
            if row["name"] == "dia_spmv":
                row["phase18_launches"]["strips_world1"] = \
                    p18["launches"].get("dia_strips", 0)
        if row["name"] == "dia_spmv":
            row.setdefault("by_workload", {})["stencil27-104"] = {"1": dia27}
            row["strip_body"] = dict(
                sharded["strip_body"],
                launches=sharded["world1_launches"]["dia_strips"])
        if row["name"] in SOLVER_WRAPPERS:
            row.setdefault("by_workload", {})["solver-laplace2d-1M"] = \
                solver_workload(solver, row["name"])
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
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_child(*(int(v) for v in sys.argv[2:5]),
                               *sys.argv[5:8]))
    sys.exit(main())
