"""Driver of the dsv2lite configuration: DeepSeek-V2-Lite's FFN stack on
pruned float32 weights, each layer built by the port's ``moe.ffn_layer``
(a ``SparseSwiGLU`` through ``auto_format`` for the leading dense layer, a
``SparseMoE`` for each MoE layer) at set-up and called in the window.

One step is the stack's layers, each on the next batch of hidden states of
the pool, dispatched back to back, then one synchronisation. The layers
are independent, as sgemv4096's products are: each call's routing can be
checked against the reference from its own input.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmarks.harness import Sampler, load_module

ref = load_module("reference", "dsv2lite")


class Program:
    """The system under test."""

    def __init__(self, cfg: dict):
        from tpusparse_torch.moe import SparseMoE, ffn_layer

        self.cfg, self.ffn_layer, self.moe = cfg, ffn_layer, SparseMoE

    def pack(self, layer: int, p: dict, batch: int, device):
        return self.ffn_layer(self.cfg, layer, p, expect_batch=batch,
                              device=device)

    def layer(self, m, x: torch.Tensor):
        """``(y, routing weights)``; None for the weights of a dense
        layer."""
        if isinstance(m, self.moe):
            return m(x, with_weights=True)
        return m(x), None

    def route(self, m) -> str:
        if isinstance(m, self.moe):
            return (f"SparseMoE(G|U {type(m.gate_up).__name__} w="
                    f"{m.gate_up.w}, D {type(m.down).__name__} g={m.down.g} "
                    f"w={m.down.w}, shared {self.route(m.shared)})")
        return (f"SparseSwiGLU(G|U {type(m.gate_up).__name__}, D "
                f"{type(m.down).__name__})")

    def counters(self, m) -> dict:
        return m.counters() if isinstance(m, self.moe) else {}


class Run:
    spans = ("step", "layer", "tps.moe", "tps.moe.route", "tps.moe.experts",
             "tps.moe.shared")

    def __init__(self, cfg, traffic, seed, device, system=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        if device.type == "cuda":
            ref.no_tf32()
        self.system = system or Program(cfg)
        self.L, self.B, self.P = cfg["layers"], traffic["batch"], \
            traffic["pool"]
        self.pool = ref.x_pool(cfg, traffic, seed, device)
        self.layers, counts = [], []
        self.pack_s = inputs_s = 0.0
        for layer in range(self.L):
            t = time.perf_counter()
            p = ref.layer_weights(cfg, seed, layer, device)
            counts.append(ref.layer_counts(cfg, p, self.pool))
            _sync(device)
            t1 = time.perf_counter()
            self.layers.append(self.system.pack(layer, p, self.B, device))
            _sync(device)
            self.pack_s += time.perf_counter() - t1
            inputs_s += t1 - t
            del p
            if device.type == "cuda":
                torch.cuda.empty_cache()
        self.route = {"layers": [self.system.route(m) for m in self.layers],
                      "batch": self.B}
        # a step's work and bytes repeat with the pool's period in steps
        period = self.P // math.gcd(self.P, self.L)

        def per_step(key):
            return [sum(c[key][(i * self.L + l) % self.P]
                        for l, c in enumerate(counts) if key in c)
                    for i in range(period)]

        self.step_bytes, self.step_flops = per_step("bytes"), \
            per_step("flops")
        self.step_routed = per_step("routed_bytes")
        self.traced = False
        self.reset()
        t = time.perf_counter()
        for i in range(traffic.get("warmup", 3)):
            self.step(i)
        _sync(device)
        self.phases = {"inputs": inputs_s, "pack": self.pack_s,
                       "warmup": time.perf_counter() - t}

    def _program_counters(self) -> dict:
        out: dict = {}
        for m in self.layers:
            for k, v in self.system.counters(m).items():
                out[k] = v if k == "moe.experts" else out.get(k, 0) + v
        return out

    def reset(self) -> None:
        """Zero the counters and the sample: the window starts."""
        self.sampler = Sampler(self.traffic["sample"], self.seed)
        self.kept: dict[int, tuple[int, list]] = {}
        self.steps = 0
        self.need = self.work = self.routed = 0
        self.start = self._program_counters()

    @property
    def attempted(self) -> int:
        return self.steps * self.L

    def step(self, i: int) -> None:
        call, layers, pool = self.system.layer, self.layers, self.pool
        base, P = i * self.L, self.P
        outs = []
        if self.traced:
            for l, m in enumerate(layers):
                with record_function("layer"):
                    outs.append(call(m, pool[(base + l) % P]))
        else:
            for l, m in enumerate(layers):
                outs.append(call(m, pool[(base + l) % P]))
        slot = self.sampler.offer(i)
        if slot is not None:
            self.kept[slot] = (i, outs)
        self.steps += 1
        j = i % len(self.step_bytes)
        self.need += self.step_bytes[j]
        self.work += self.step_flops[j]
        self.routed += self.step_routed[j]

    def counters(self) -> dict:
        now = self._program_counters()
        out = {k: v if k == "moe.experts" else v - self.start.get(k, 0)
               for k, v in now.items()}
        return {**out, "layer_calls": self.attempted,
                "step_bytes": self.need, "flops": self.work,
                "moe_bytes": self.routed, "pack_s": self.pack_s}

    def end_to_end(self, loop: dict) -> dict:
        return {"pass_ms_p95": float(np.percentile(loop["step_ms"], 95))}

    def release(self) -> None:
        self.layers = []

    def check(self):
        """Each kept step's layer outputs against the float64 reference from
        the same input, token by token: ``err``, the widest gap over the
        reference's scale; ``route_flips``, tokens whose experts differ from
        the reference's top k where its k-th and (k+1)-th scores lie more
        than ``tau`` apart; ``score_err``, the widest gap of the program's
        routing weights from the reference's on the experts both chose;
        ``ties``, the tokens within ``tau`` whose experts differ, judged
        under the program's own experts (never a failure: limit = tokens
        checked)."""
        cfg, lim = self.cfg, self.cfg["limits"]
        k = cfg["num_experts_per_tok"]
        worst = score = 0.0
        flips = ties = tokens = failed = 0
        for layer in range(self.L):
            kept = [((i * self.L + layer) % self.P, outs[layer])
                    for i, outs in self.kept.values()]
            if not kept:
                continue
            p = ref.layer_weights(cfg, self.seed, layer, self.device)
            x = torch.cat([self.pool[j] for j, _ in kept])
            y = torch.cat([o[0] for _, o in kept]).double()
            u = ref.normed(cfg, p, x)
            idx, flip = None, torch.zeros(len(x), dtype=torch.bool,
                                          device=x.device)
            if "mlp" not in p:
                w = torch.cat([o[1] for _, o in kept]).double()
                s = ref.scores(p, u)
                top = s.topk(k + 1, dim=-1)
                gap = top.values[:, k - 1] - top.values[:, k]
                mine = w.topk(k, dim=-1).indices
                differ = (torch.zeros_like(s, dtype=torch.bool)
                          .scatter_(1, mine, True)
                          != torch.zeros_like(s, dtype=torch.bool)
                          .scatter_(1, top.indices[:, :k], True)).any(1)
                flip = differ & (gap > lim["tau"])
                tie = differ & ~flip
                flips += int(flip.sum())
                ties += int(tie.sum())
                idx = torch.where(tie[:, None], mine, top.indices[:, :k])
            tokens += len(x)
            want, scale, weights = ref.answer(cfg, p, u, idx)
            if weights is not None:
                both = (weights != 0) & (w != 0)
                if both.any():     # a gap that is not finite reads inf
                    score = max(score, float(torch.nan_to_num(
                        (w - weights).abs()[both], nan=math.inf).max()))
            e = _gaps(y, want, scale)
            worst = max(worst, float(e.max()))
            bad = (e > lim["err"]) | flip
            failed += int(bad.view(len(kept), -1).any(1).sum())
            del p
        return {"err": (worst, lim["err"]),
                "score_err": (score, lim["score_err"]),
                "route_flips": (flips, 0), "ties": (ties, tokens)}, failed


def _gaps(y: torch.Tensor, want: torch.Tensor,
          scale: torch.Tensor) -> torch.Tensor:
    """Each token's widest gap of ``y`` from ``want`` over ``scale``;
    infinite where ``y`` is not finite or is off where the scale is 0."""
    if y.shape != want.shape:
        return torch.full(want.shape[:1], math.inf, device=want.device)
    gap = (y - want).abs()
    e = torch.where(scale > 0, gap / scale.clamp(min=1e-300),
                    torch.where(gap > 0, math.inf, 0.0))
    e = torch.where(torch.isfinite(y), e, math.inf)
    return e.max(dim=1).values


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
