"""Plain reference of DeepSeek-V2's FFN layers (``modeling_deepseek.py``'s
``DeepseekV2MLP`` and ``DeepseekV2MoE``, attention left out), in plain
torch at float32 or float64, for ``tpusparse_torch.moe``'s tests.

It imports nothing of the port: weights are dense tensors (zero where
pruned), ``A`` of shape (in, out) for ``y = x A``, and a MoE layer runs
expert by expert, one dense weight at a time, with no stacking, no kernels
and no batching tricks. For hidden states x (B, hidden):

- ``u = RMSNorm(x) = x / sqrt(mean(x^2) + eps) * weight``;
- ``MLP(u) = (silu(u G) * (u U)) D``;
- dense layer: ``y = MLP(u)``;
- MoE layer: ``s = softmax(u R)``; ``T`` the top ``num_experts_per_tok``
  of ``s`` (greedy); the weights ``s_e`` on ``T``, divided by their sum
  when ``norm_topk_prob``, else times ``routed_scaling_factor`` (as HF's
  ``MoEGate``); ``y = sum_{e in T} s_e MLP_e(u) + MLP_shared(u)``.

A layer's weights are a dict: ``norm`` (hidden,), ``mlp`` (G, U, D) for the
dense layer; for a MoE layer ``router`` (hidden, E), ``experts`` a list of
E (G, U, D) and ``shared`` (G, U, D), one MLP of width ``n_shared * w``.
"""

from __future__ import annotations

import torch


def no_tf32() -> None:
    """Float32 products on the card in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def prune_half(w: torch.Tensor) -> torch.Tensor:
    """``w`` (in, out) with each output keeping exactly half of its inputs
    (``in // 2``), the largest by magnitude: Wanda's per-output comparison
    group with every input's activation norm taken as 1."""
    keep = w.abs().topk(w.shape[0] // 2, dim=0).indices
    mask = torch.zeros_like(w, dtype=torch.bool).scatter_(0, keep, True)
    return w * mask


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def mlp(u: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
        down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(u @ gate) * (u @ up)) @ down


def route(u: torch.Tensor, router: torch.Tensor, cfg: dict):
    """``(scores, weights)``, each (B, E): the softmax scores and the
    routing weights, zero off each token's top k."""
    if cfg["scoring_func"] != "softmax" or cfg["topk_method"] != "greedy":
        raise ValueError("only softmax scoring with greedy top-k")
    s = torch.softmax(u @ router, dim=-1)
    top, idx = s.topk(cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"] and cfg["num_experts_per_tok"] > 1:
        top = top / (top.sum(-1, keepdim=True) + 1e-20)
    else:
        top = top * cfg["routed_scaling_factor"]
    return s, torch.zeros_like(s).scatter_(1, idx, top)


def _mlp(u: torch.Tensor, w, dtype) -> torch.Tensor:
    return mlp(u, *(t.to(dtype) for t in w))


def dense_layer(x: torch.Tensor, p: dict, cfg: dict,
                dtype=torch.float64) -> torch.Tensor:
    if x.is_cuda:
        no_tf32()
    u = rms_norm(x.to(dtype), p["norm"].to(dtype), cfg["rms_norm_eps"])
    return _mlp(u, p["mlp"], dtype)


def moe_layer(x: torch.Tensor, p: dict, cfg: dict, dtype=torch.float64,
              weights: torch.Tensor | None = None) -> torch.Tensor:
    """The MoE layer's output; ``weights`` (B, E), where given, replaces
    the layer's own routing (the reference under another route)."""
    if x.is_cuda:
        no_tf32()
    u = rms_norm(x.to(dtype), p["norm"].to(dtype), cfg["rms_norm_eps"])
    if weights is None:
        weights = route(u, p["router"].to(dtype), cfg)[1]
    weights = weights.to(dtype)
    y = _mlp(u, p["shared"], dtype)
    for e, w in enumerate(p["experts"]):
        y = y + weights[:, e:e + 1] * _mlp(u, w, dtype)
    return y
