"""Driver of the hpcg27 configuration: HPCG's 27-point operator on a 3-D
grid, solved by the port's CG (``tpusparse_torch.solve.cg``) over a
``DiaMatrix`` that K8 applies.

The ``DiaMatrix`` is built on the device straight from the stencil, with
the offsets, symmetric storage and values that ``DiaMatrix.from_csr``
gives for the same operator: a stencil code knows its stencil, and a host
CSR of the whole grid would cost every run minutes. One step is one whole
solve from x0 = 0 to the tolerance, of the next right-hand side of the
pool.
"""

from __future__ import annotations

import itertools
import time

import torch
from torch.profiler import record_function

from benchmarks.harness import Sampler, load_module

ref = load_module("reference", "hpcg27")


def stencil_dia(cfg: dict, dims, device):
    """The operator as a symmetric ``DiaMatrix``: its offsets ``d >= 0``
    ascending, each row ``vals[i, c] = A[c + d_i, c]``."""
    from tpusparse_torch.formats.dia import DiaMatrix

    nx, ny, nz = dims
    n = nx * ny * nz
    steps = {}
    for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3):
        d = dx + nx * (dy + ny * dz)
        if d >= 0:
            steps[d] = (dx, dy, dz)
    offsets = sorted(steps)
    vals = torch.empty((len(offsets), n), dtype=torch.float32,
                       device=device)
    idx = [torch.arange(s, device=device) for s in dims]
    for row, d in enumerate(offsets):
        if d == 0:
            vals[row].fill_(cfg["diagonal"])
            continue
        ok = [(i + s >= 0) & (i + s < len(i)) for i, s in
              zip(idx, steps[d])]
        mask = ok[2][:, None, None] & ok[1][None, :, None] & \
            ok[0][None, None, :]
        vals[row] = torch.where(mask, cfg["off_diagonal"], 0.0).reshape(-1)
    return DiaMatrix(tuple(offsets), vals, (n, n), ref.nnz(dims), sym=True)


class Program:
    """The system under test."""

    def __init__(self, cfg: dict):
        from tpusparse_torch.solve import cg

        self.cfg, self.cg = cfg, cg

    def operator(self, dims, device):
        return stencil_dia(self.cfg, dims, device)

    def solve(self, op, b, tol, maxiter, apply_=None):
        x, info = self.cg(apply_ or op, b, tol=tol, maxiter=maxiter)
        return x, info["iters"]

    def route(self, op) -> str:
        from tpusparse_torch.kernels.dia_spmv import fits

        return (f"DiaMatrix sym={op.sym} diagonals={len(op.offsets)} "
                f"K8={fits(op.offsets, op.sym, op.shape[0])}")


class Run:
    spans = ("solve", "spmv")

    def __init__(self, cfg, traffic, seed, device, system=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.system = system or Program(cfg)
        self.dims = tuple(traffic["grid"])
        self.n = ref.size(self.dims)
        _sync(device)
        t = time.perf_counter()
        self.op = self.system.operator(self.dims, device)
        _sync(device)
        self.pack_s = time.perf_counter() - t
        self.route = {"operator": self.system.route(self.op),
                      "grid": list(self.dims)}
        t = time.perf_counter()
        self.b = [ref.rhs(seed, i, self.n, device)
                  for i in range(traffic["pool"])]
        _sync(device)
        inputs_s = time.perf_counter() - t
        t = time.perf_counter()
        getattr(self.op, "plan", None)      # K8's plan, built once
        plan_s = time.perf_counter() - t
        # bytes one application needs: the stored upper triangle with the
        # diagonal, 4 B a value, then x read and y written once
        self.apply_bytes = 4 * (ref.nnz(self.dims) + self.n) // 2 + \
            8 * self.n
        self.traced = False
        self.reset()
        t = time.perf_counter()
        for i in range(traffic.get("warmup", 1)):
            self.step(i)
        _sync(device)
        self.phases = {"inputs": inputs_s, "pack": self.pack_s,
                       "plan": plan_s, "warmup": time.perf_counter() - t}

    def reset(self) -> None:
        self.sampler = Sampler(self.traffic["sample"], self.seed)
        self.kept: dict[int, tuple[int, torch.Tensor]] = {}
        self.solves = 0
        self.iters = 0
        self.applies = 0
        self.unconverged = 0

    @property
    def attempted(self) -> int:
        return self.solves

    def _spanned(self, v):
        self.applies += 1
        with record_function("spmv"):
            return self.op.spmv(v)

    def step(self, i: int) -> None:
        j = i % len(self.b)
        x, iters = self.system.solve(
            self.op, self.b[j], self.cfg["tol"], self.traffic["maxiter"],
            self._spanned if self.traced else None)
        slot = self.sampler.offer(i)
        if slot is not None:
            self.kept[slot] = (j, x)
        self.solves += 1
        self.iters += iters
        self.unconverged += iters >= self.traffic["maxiter"]

    def counters(self) -> dict:
        return {"solves": self.solves, "iters": self.iters,
                "spmv_bytes": self.applies * self.apply_bytes,
                # x, r and p read and written once an iteration, Ap read
                "vector_bytes": self.iters * 7 * 4 * self.n,
                "flops": self.applies * 2 * ref.nnz(self.dims),
                "pack_s": self.pack_s}

    def end_to_end(self, loop: dict) -> dict:
        return {"solve_ms": loop["elapsed_s"] / self.solves * 1e3}

    def release(self) -> None:
        self.op = None
        self.b = []

    def check(self):
        """Each kept solution's true residual in float64; a solve that ran
        to the cap without reaching the tolerance fails by itself."""
        limit = self.cfg["limits"]["residual"]
        worst, failed = 0.0, self.unconverged
        for j, x in self.kept.values():
            b = ref.rhs(self.seed, j, self.n, self.device)
            e = ref.residual(self.cfg, x, b, self.dims)
            worst = max(worst, e)
            failed += not e <= limit
        return {"residual": (worst, limit),
                "unconverged": (self.unconverged, 0)}, failed


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
