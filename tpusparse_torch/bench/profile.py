"""``python -m tpusparse_torch.bench.profile``: where one headline call's
device time goes, kernel by kernel.

For each headline entry at B = 1 and B = 8 (the canonical 4096 x 4096,
d = 0.5 workload), for the router's skew path (8192 x 8192 powerlaw,
d = 0.15: RSELL with its unpermute at B = 1, ASP at B = 8), its
block-structured path (blockpruned-4096: TCSR's SELL tier, K7, at B = 1 and
its dense tier, K6, at B = 8) and its banded path (the 1024^2 5-point
Laplacian as DIA: K8 at B = 1, the shifted torch form at B = 8), each as
``auto_format`` picks them, for the training path (``trainable_linear``
on the canonical matrix: K10 alone, and the fwd+bwd step with dx and both
value gradients, K1 x2 + K10 x2, at B = 1 and 8), for ``bell_cuda`` (K12)
on the canonical workload at B = 1 and 8, for binned SELL (K1 per bucket,
then K5) on the skew matrix at B = 1, and for K11 at the floors study's
points (4096^2, d in {0.1, 0.5}, B in {1, 8, 32}), it traces ``REPS``
calls with ``torch.profiler``, each after the same read-only 256 MB L2
flush as ``bench.runner``, and prints one JSON line per entry: every CUDA
kernel's device time per call (the flush's reduction and the memset it
issues left out) and their sum. Comparing the sum with ``device_time``'s
per-call time shows how much of a call the device spends idle between
kernels. Needs a CUDA device.
"""

from __future__ import annotations

import json

import torch

import numpy as np

from tpusparse_torch.autodiff import trainable_linear
from tpusparse_torch.bench.runner import FLUSH_BYTES
from tpusparse_torch.bench.suite import _canonical_workload, _fmt_run, registry
from tpusparse_torch.config import SpmvConfig
from tpusparse_torch.bench import report
from tpusparse_torch.formats.auto import auto_format, matrix_stats
from tpusparse_torch.formats.bell import BellMatrix
from tpusparse_torch.formats.binned import BinnedSellMatrix
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.kernels.sell_grad import sell_dvals
from tpusparse_torch.kernels.sell_mxu_spmm import sell_mxu_spmm
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import resolve_device

REPS = 10


def kernel_times(run, fmt, x) -> dict[str, float]:
    """Device microseconds per call of each CUDA kernel ``run`` launches."""
    scratch = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32,
                          device=x.device)
    for _ in range(3):
        run(fmt, x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            scratch.sum()
            run(fmt, x)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or "at::native::reduce_kernel" in evt.key \
                or evt.key.startswith("Memset"):
            continue
        out[evt.key[:80]] = evt.self_device_time_total / REPS
    return out


def _report(name: str, batch: int, times: dict[str, float]) -> None:
    print(json.dumps({"entry": name, "batch": batch,
                      "kernel_us_per_call": times,
                      "sum_us": sum(times.values()),
                      "device": torch.cuda.get_device_name(0)}))


def main() -> None:
    dev = resolve_device(None)
    for batch in (1, 8):
        a, x = _canonical_workload(SpmvConfig(batch=batch))
        xt = torch.as_tensor(x, device=dev)
        for e in registry():
            _report(e["name"], batch,
                    kernel_times(e["run"], e["prepare"](a, dev), xt))
    a = generators.random_sparse_matrix(8192, 8192, density=0.15, seed=0,
                                        distribution="powerlaw")
    stats = matrix_stats(a)
    for batch in (1, 8):
        fmt = auto_format(a, expect_batch=batch, stats=stats, device=dev)
        x = generators.random_sparse_batch(batch, 8192, 0.5, seed=0)
        xt = torch.as_tensor(x[0] if batch == 1 else x, device=dev)
        _report(f"skew_{type(fmt).__name__}", batch,
                kernel_times(_fmt_run, fmt, xt))
    x = torch.as_tensor(generators.random_sparse_vector(8192, 0.5, seed=0),
                        device=dev)
    _report("skew_binned", 1, kernel_times(
        _fmt_run, BinnedSellMatrix.from_dense(a, device=dev), x))
    a = generators.block_pruned_matrix(4096, 4096, block=128, keep_frac=0.3,
                                       fill=0.5, seed=9)
    stats = matrix_stats(a)
    for batch in (1, 8):
        fmt = auto_format(a, expect_batch=batch, stats=stats, device=dev)
        x = generators.random_sparse_batch(batch, 4096, 0.5, seed=0)
        xt = torch.as_tensor(x[0] if batch == 1 else x, device=dev)
        _report(f"block_{type(fmt).__name__}", batch,
                kernel_times(_fmt_run, fmt, xt))
    csr = generators.stencil_csr((1024, 1024))
    fmt = auto_format(csr, device=dev)
    for batch in (1, 8):
        x = generators.random_sparse_batch(batch, csr.shape[0], 0.5, seed=0)
        xt = torch.as_tensor(x[0] if batch == 1 else x, device=dev)
        _report(f"banded_{type(fmt).__name__}", batch,
                kernel_times(_fmt_run, fmt, xt))
    _training(dev)
    _bell_and_floors(dev)


def _bell_and_floors(dev) -> None:
    """K12 on the canonical workload, and K11 at the floors points."""
    for batch in (1, 8):
        a, x = _canonical_workload(SpmvConfig(batch=batch))
        _report("bell_cuda", batch, kernel_times(
            _fmt_run, BellMatrix.from_dense(a, device=dev),
            torch.as_tensor(x, device=dev)))
    for wl in report.workloads(dev):
        s = wl["sell"]
        for batch in report.BATCHES:
            x = torch.as_tensor(report.grid_batch(batch), device=dev)
            _report(f"floors_K11_d{wl['density']}", batch, kernel_times(
                lambda f, xx: sell_mxu_spmm(f.idx, f.vals, xx), s, x))


def _training(dev) -> None:
    """K10 alone and the fwd+bwd step on the canonical matrix."""
    a, _ = _canonical_workload(SpmvConfig())
    apply, params, _, _ = trainable_linear(CsrMatrix.from_dense(a),
                                           device=dev)
    targets = [params["vals"], params["vals_t"]]
    for batch in (1, 8):
        x = torch.as_tensor(generators.random_sparse_batch(
            batch, a.shape[0], 0.5, seed=0), device=dev)
        g = torch.as_tensor(np.random.default_rng(0).uniform(
            -1, 1, (batch, a.shape[1])).astype(np.float32), device=dev)
        _report("train_K10", batch, kernel_times(
            lambda s, xx: sell_dvals(s, xx, g), apply.statics["s_f"], x))
        xr = x.clone().requires_grad_()
        _report("train_step", batch, kernel_times(
            lambda p, xx: torch.autograd.grad(apply(p, xx), targets + [xx],
                                              g), params, xr))


if __name__ == "__main__":
    main()
