"""DeepSeek-V2's FFN layers on pruned weights, for inference (no autograd):
``SparseSwiGLU`` (the dense leading layers, and the shared experts) and
``SparseMoE`` (router, routed experts and shared experts), built by
``ffn_layer`` from the model's ``config.json`` keys.

The equations are ``testing/moe_reference.py``'s, HF ``modeling_deepseek.py``'s
``DeepseekV2MLP`` and ``DeepseekV2MoE`` with the attention half left out:
``u = RMSNorm(x)``, ``MLP(u) = (silu(u G) * (u U)) D``; a dense layer gives
``MLP(u)``; a MoE layer gives ``sum_{e in T} s_e MLP_e(u) + MLP_shared(u)``,
with ``s = softmax(u R)`` and ``T`` each token's greedy top k of ``s``, the
weights divided by their sum where ``norm_topk_prob`` (and k > 1), else times
``routed_scaling_factor``.

Weights come dense, zero where pruned, as ``A`` of shape (in, out) for
``y = x A`` (the transpose of an ``nn.Linear`` weight). ``SparseSwiGLU``
packs ``[G | U]`` and ``D`` through ``auto_format`` with the caller's
``expect_batch``. ``SparseMoE`` knows its experts' structure and packs them
itself: every expert's G and U side by side into one ``SellMatrix``
``[G_0 .. G_{E-1} | U_0 .. U_{E-1}]`` (expert e at columns ``[e w, (e+1) w)``
of each half), and every expert's D stacked along the input into one
``AwspMatrix`` of ``g = w / 128`` windows a group, so that group e is
expert e. A forward reads nothing back to the host:

1. ``u = RMSNorm(x)``; ``s = softmax(u R)`` in float32, the product with
   TF32 off; the (B, E) routing weights, zero off each token's top k;
2. one K1 product gives ``[g | v]`` over every expert;
3. ``h = silu(g) * v * weight``, each expert's w columns times its weight,
   so zero for the experts a token does not route to;
4. ``y = h D`` by K3 over the groups its device plan finds live in ``h``
   (the experts some token routes to), plus ``shared(u)``.

Spans (``trace.py``: nothing until a profiler records):

- ``tps.moe``: a ``SparseMoE`` forward;
- ``tps.moe.route``: the router's product, softmax, top-k and weight tensor;
- ``tps.moe.experts``: the stacked G/U product, the SwiGLU, K3's plan and K3;
- ``tps.moe.shared``: the shared experts.

Counters, per layer (``SparseMoE.counters()``): ``moe.calls``, the forwards;
``moe.live_groups``, the live groups (experts) of K3's plans summed over the
forwards on the device, read back only when the counters are read;
``moe.experts``, E.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpusparse_torch.formats.auto import auto_format
from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.formats.sell import SellMatrix, as_input
from tpusparse_torch.trace import recording, span
from tpusparse_torch.utils import resolve_device

_LANES = 128


def _check(cfg: dict) -> None:
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r}: only silu")
    if cfg.get("scoring_func", "softmax") != "softmax" \
            or cfg.get("topk_method", "greedy") != "greedy":
        raise ValueError("only softmax scoring with greedy top-k")


def _f32(t, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32).to(device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32, TF32 off on the card whatever the process
    set."""
    flags = torch.backends.cuda.matmul
    if a.is_cuda and flags.allow_tf32:
        flags.allow_tf32 = False
        try:
            return a @ b
        finally:
            flags.allow_tf32 = True
    return a @ b


class SparseSwiGLU:
    """``MLP(u) = (silu(u G) * (u U)) D`` on pruned weights, ``[G | U]``
    (hidden, 2 w) and ``D`` (w, hidden) packed by ``auto_format``;
    ``forward`` puts an RMSNorm before it where ``norm`` is given."""

    def __init__(self, gate, up, down, *, norm=None, eps: float = 1e-6,
                 expect_batch: int = 1, device=None):
        dev = resolve_device(device)
        gate, up, down = (torch.as_tensor(t, dtype=torch.float32)
                          for t in (gate, up, down))
        hidden, self.width = gate.shape
        if up.shape != gate.shape or down.shape != (self.width, hidden):
            raise ValueError(f"SparseSwiGLU: G {tuple(gate.shape)}, U "
                             f"{tuple(up.shape)}, D {tuple(down.shape)}")
        self.gate_up = auto_format(torch.cat([gate, up], dim=1),
                                   expect_batch=expect_batch, device=dev)
        self.down = auto_format(down, expect_batch=expect_batch, device=dev)
        self.norm = None if norm is None else _f32(norm, dev)
        self.eps, self.device = eps, dev

    def __call__(self, x) -> torch.Tensor:
        return self.forward(x)

    def forward(self, x) -> torch.Tensor:
        """x (B, hidden) -> (B, hidden)."""
        u = as_input(x, self.device)
        if self.norm is not None:
            u = rms_norm(u, self.norm, self.eps)
        return self.mlp(u)

    def mlp(self, u: torch.Tensor) -> torch.Tensor:
        gv = self.gate_up.spmm(u)
        w = self.width
        return self.down.spmm(F.silu(gv[:, :w]) * gv[:, w:])


class SparseMoE:
    """A DeepSeek-V2 MoE layer on pruned weights (module docstring).
    ``weights``: ``norm`` (hidden,), ``router`` (hidden, E) dense,
    ``experts`` E triples (G, U, D) of shapes (hidden, w), (hidden, w),
    (w, hidden), and ``shared`` one triple of width ``n_shared_experts * w``.
    ``expect_batch`` goes to the shared experts' ``auto_format``."""

    def __init__(self, cfg: dict, weights: dict, *, expect_batch: int = 1,
                 device=None):
        _check(cfg)
        dev = resolve_device(device)
        e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        hidden, experts = cfg["hidden_size"], weights["experts"]
        if w % _LANES or len(experts) != e:
            raise ValueError(f"SparseMoE: {len(experts)} experts of width {w}"
                             f"; needs {e}, each a multiple of {_LANES}")
        for g, u, d in experts:
            if tuple(g.shape) != (hidden, w) or tuple(u.shape) != (hidden, w) \
                    or tuple(d.shape) != (w, hidden):
                raise ValueError("SparseMoE: an expert's G, U or D is not "
                                 f"({hidden}, {w}), ({hidden}, {w}), "
                                 f"({w}, {hidden})")
        f32 = torch.float32
        self.gate_up = SellMatrix.from_dense(torch.cat(
            [torch.as_tensor(t[i], dtype=f32) for i in (0, 1)
             for t in experts], dim=1), device=dev)
        self.down = AwspMatrix.from_dense(torch.cat(
            [torch.as_tensor(t[2], dtype=f32) for t in experts]),
            g=w // _LANES, device=dev)
        self.router = _f32(weights["router"], dev)
        self.norm = _f32(weights["norm"], dev)
        self.shared = None
        if cfg.get("n_shared_experts"):
            self.shared = SparseSwiGLU(*weights["shared"],
                                       expect_batch=expect_batch, device=dev)
            if self.shared.width != cfg["n_shared_experts"] * w:
                raise ValueError(f"SparseMoE: shared width "
                                 f"{self.shared.width}, config "
                                 f"{cfg['n_shared_experts']} x {w}")
        self.experts, self.width = e, w
        self.top_k = cfg["num_experts_per_tok"]
        self.normalize = self.top_k > 1 and bool(cfg["norm_topk_prob"])
        self.scale = float(cfg["routed_scaling_factor"])
        self.eps = float(cfg["rms_norm_eps"])
        self.device = dev
        self.calls = 0
        self.live_groups = torch.zeros(1, dtype=torch.int64, device=dev)

    def __call__(self, x, **kw):
        return self.forward(x, **kw)

    def forward(self, x, *, with_weights: bool = False):
        """x (B, hidden) -> y (B, hidden), or ``(y, weights)`` with the
        (B, E) routing weights the layer used."""
        if recording():
            with span("tps.moe"):
                return self._forward(x, with_weights)
        return self._forward(x, with_weights)

    def _forward(self, x, with_weights: bool):
        u = rms_norm(as_input(x, self.device), self.norm, self.eps)
        with span("tps.moe.route"):
            weights = self.route(u)
        with span("tps.moe.experts"):
            y = self.routed(u, weights)
        if self.shared is not None:
            with span("tps.moe.shared"):
                y += self.shared.mlp(u)
        self.calls += 1
        return (y, weights) if with_weights else y

    def route(self, u: torch.Tensor) -> torch.Tensor:
        """The (B, E) routing weights of normed ``u``: zero off each
        token's top k of ``softmax(u R)``."""
        s = torch.softmax(_matmul_fp32(u, self.router), dim=-1)
        top, idx = s.topk(self.top_k, dim=-1)
        if self.normalize:
            top = top / (top.sum(-1, keepdim=True) + 1e-20)
        elif self.scale != 1.0:
            top = top * self.scale
        return torch.zeros_like(s).scatter_(1, idx, top)

    def routed(self, u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """``sum_e weights_e MLP_e(u)`` over every expert: K1 on the stacked
        G/U, the weighted SwiGLU, then K3 over the live experts' D."""
        b, ew = u.shape[0], self.experts * self.width
        gv = self.gate_up.spmm(u)
        h = F.silu(gv[:, :ew].view(b, self.experts, self.width))
        h.mul_(gv[:, ew:].view(b, self.experts, self.width))
        h = h.mul_(weights.unsqueeze(-1)).view(b, ew)
        plan = self.down.device_plan(h)
        self.live_groups += plan[1]
        return self.down.spmm(h, plan=plan)

    def counters(self) -> dict[str, int]:
        """``moe.calls``, ``moe.live_groups`` (one host read) and
        ``moe.experts``."""
        return {"moe.calls": self.calls,
                "moe.live_groups": int(self.live_groups.item()),
                "moe.experts": self.experts}


def is_moe_layer(cfg: dict, layer: int) -> bool:
    """HF's rule: layer ``layer`` (from 0) is a MoE layer."""
    return bool(cfg.get("n_routed_experts")) \
        and layer >= cfg["first_k_dense_replace"] \
        and layer % cfg["moe_layer_freq"] == 0


def ffn_layer(cfg: dict, layer: int, weights: dict, *, expect_batch: int = 1,
              device=None):
    """The FFN half of decoder layer ``layer``: a ``SparseMoE``, or a
    ``SparseSwiGLU`` with its RMSNorm from ``weights`` ``norm`` and
    ``mlp`` (G, U, D) of width ``intermediate_size``."""
    if is_moe_layer(cfg, layer):
        return SparseMoE(cfg, weights, expect_batch=expect_batch,
                         device=device)
    _check(cfg)
    return SparseSwiGLU(*weights["mlp"], norm=weights["norm"],
                        eps=cfg["rms_norm_eps"], expect_batch=expect_batch,
                        device=device)
