"""Driver of the sgemv4096 configuration: a stack of pruned 4096 x 4096
float32 weights, each product ``Y = X A_l`` through the port's public path
(``auto_format`` at set-up, ``ops.spmv`` / ``ops.spmm`` in the window).

One step is one pass: the stack's products, each with the next activation
of the pool, dispatched back to back, then one synchronisation. The
products are independent, as in the reference's own harness, which draws
a fresh X for every product.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import record_function

from benchmarks.harness import Sampler, load_module

ref = load_module("reference", "sgemv4096")


class Program:
    """The system under test."""

    def __init__(self, cfg: dict):
        from tpusparse_torch import ops
        from tpusparse_torch.formats.auto import auto_format

        self.auto_format, self.ops = auto_format, ops

    def pack(self, a: torch.Tensor, batch: int):
        return self.auto_format(a, expect_batch=batch, device=a.device)

    def product(self, p, x: torch.Tensor) -> torch.Tensor:
        return self.ops.spmv(p, x) if x.ndim == 1 else self.ops.spmm(p, x)

    def route(self, p) -> str:
        return type(p).__name__


class Run:
    spans = ("pass", "product")

    def __init__(self, cfg, traffic, seed, device, system=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.system = system or Program(cfg)
        self.L, self.B, self.P = cfg["layers"], traffic["batch"], \
            traffic["pool"]
        self.pool = ref.x_pool(cfg, traffic, seed, device)
        self.xs = [self.pool[j, 0] if self.B == 1 else self.pool[j]
                   for j in range(self.P)]
        self.packs, self.nnz, self.bytes = [], [], []
        self.pack_s = inputs_s = 0.0
        for layer in range(self.L):
            t = time.perf_counter()
            a = ref.weight(cfg, seed, layer, device)
            self.nnz.append(int((a != 0).sum()))
            self.bytes.append(ref.product_bytes(a, self.pool))
            _sync(device)
            t1 = time.perf_counter()
            self.packs.append(self.system.pack(a, self.B))
            _sync(device)
            self.pack_s += time.perf_counter() - t1
            inputs_s += t1 - t
            del a
        routes = defaultdict(int)
        for p in self.packs:
            routes[self.system.route(p)] += 1
        self.route = {"layers": dict(routes), "batch": self.B}
        # a pass's work and bytes repeat with the pool's period in passes
        period = self.P // math.gcd(self.P, self.L)
        self.pass_bytes = [
            sum(self.bytes[l][(i * self.L + l) % self.P]
                for l in range(self.L)) for i in range(period)]
        self.pass_work = sum(self.nnz) * self.B
        self.traced = False
        self.reset()
        t = time.perf_counter()
        for i in range(traffic.get("warmup", 3)):
            self.step(i)
        _sync(device)
        self.phases = {"inputs": inputs_s, "pack": self.pack_s,
                       "warmup": time.perf_counter() - t}

    def reset(self) -> None:
        """Zero the counters and the sample: the window starts."""
        self.sampler = Sampler(self.traffic["sample"], self.seed)
        self.kept: dict[int, tuple[int, list]] = {}
        self.passes = 0
        self.work = 0
        self.need = 0

    @property
    def attempted(self) -> int:
        return self.passes * self.L

    def step(self, i: int) -> None:
        product, packs, xs = self.system.product, self.packs, self.xs
        base, P = i * self.L, self.P
        ys = []
        if self.traced:
            for layer, p in enumerate(packs):
                with record_function("product"):
                    ys.append(product(p, xs[(base + layer) % P]))
        else:
            for layer, p in enumerate(packs):
                ys.append(product(p, xs[(base + layer) % P]))
        slot = self.sampler.offer(i)
        if slot is not None:
            self.kept[slot] = (i, ys)
        self.passes += 1
        self.work += self.pass_work
        self.need += self.pass_bytes[i % len(self.pass_bytes)]

    def counters(self) -> dict:
        return {"products": self.attempted, "product_bytes": self.need,
                "flops": 2 * self.work, "pack_s": self.pack_s}

    def end_to_end(self, loop: dict) -> dict:
        return {"pass_ms_p95": float(np.percentile(loop["step_ms"], 95))}

    def release(self) -> None:
        self.packs = []

    def check(self):
        """Each kept pass's products against ``x A`` in float64."""
        limit = self.cfg["limits"]["err"]
        by_layer = defaultdict(list)
        for i, ys in self.kept.values():
            for layer, y in enumerate(ys):
                by_layer[layer].append((y, (i * self.L + layer) % self.P))
        worst, failed = 0.0, 0
        for layer in sorted(by_layer):
            a = ref.weight(self.cfg, self.seed, layer, self.device)
            for y, j in by_layer[layer]:
                e = ref.product_error(a, self.pool[j], y)
                worst = max(worst, e)
                failed += not e <= limit
        return {"err": (worst, limit)}, failed


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
