"""Plain reference of the dsv2lite configuration: DeepSeek-V2-Lite's FFN
layers (HF ``modeling_deepseek.py``'s ``DeepseekV2MLP`` and
``DeepseekV2MoE``, attention left out) on weights pruned to half, their
inputs, the bytes and operations a layer needs, the reference's answer
with its scale, and the TF32 control.

Plain torch; it imports nothing of the program. A run makes the weights
and the pool of hidden states here from the seed, on the device, and hands
the same tensors to the program; the check makes the weights again.

Weights are ``A`` of shape (in, out) for ``y = x A``. For hidden states
x (B, hidden): ``u = RMSNorm(x)``, ``MLP(u) = (silu(u G) * (u U)) D``; the
dense layer gives ``MLP(u)``; a MoE layer gives ``sum_{e in T} s_e MLP_e(u)
+ MLP_shared(u)`` with ``s = softmax(u R)`` and ``T`` the greedy top k of
``s`` (divided by their sum where ``norm_topk_prob``, else times
``routed_scaling_factor``). The reference runs expert by expert, one dense
weight at a time.
"""

from __future__ import annotations

import torch

from benchmarks.plain import generator, tf32

SILU_SLOPE = 1.1       # sup |silu'(t)| = 1.0998


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def is_moe(cfg: dict, layer: int) -> bool:
    return layer >= cfg["first_k_dense_replace"] \
        and layer % cfg["moe_layer_freq"] == 0


def prune(w: torch.Tensor, density: float) -> torch.Tensor:
    """Each output (column) keeps ``round(density * in)`` of its inputs,
    the largest by magnitude: Wanda's per-output comparison group with
    every input's activation norm taken as 1."""
    keep = w.abs().topk(round(density * w.shape[0]), dim=0).indices
    return w * torch.zeros_like(w, dtype=torch.bool).scatter_(0, keep, True)


def _matrix(cfg, seed, layer, tags, shape, device) -> torch.Tensor:
    """uniform(-1, 1) * sqrt(3 / in) (variance 1 / in), pruned."""
    g = generator(device, seed, 1, layer, *tags)
    w = torch.rand(shape, generator=g, device=device).mul_(2).sub_(1)
    return prune(w.mul_((3.0 / shape[0]) ** 0.5), cfg["density"])


def _mlp_weights(cfg, seed, layer, tag, hidden, width, device):
    return tuple(_matrix(cfg, seed, layer, (tag, i), shape, device)
                 for i, shape in enumerate(((hidden, width), (hidden, width),
                                            (width, hidden))))


def layer_weights(cfg: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s weights: ``norm`` uniform(0.75, 1.25); the dense
    layer's ``mlp`` (G, U, D); a MoE layer's dense ``router`` N(0, 1 /
    hidden), ``experts`` (E triples) and ``shared`` (one triple of width
    ``n_shared_experts * w``)."""
    hidden = cfg["hidden_size"]
    g = generator(device, seed, 1, layer, 0)
    norm = torch.rand(hidden, generator=g, device=device).sub_(0.5) \
        .mul_(0.5).add_(1.0)
    if not is_moe(cfg, layer):
        return {"norm": norm, "mlp": _mlp_weights(
            cfg, seed, layer, 1, hidden, cfg["intermediate_size"], device)}
    e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    router = torch.randn((hidden, e), generator=g, device=device) \
        .mul_(hidden ** -0.5)
    return {"norm": norm, "router": router,
            "experts": [_mlp_weights(cfg, seed, layer, 2 + i, hidden, w,
                                     device) for i in range(e)],
            "shared": _mlp_weights(cfg, seed, layer, 1, hidden,
                                   cfg["n_shared_experts"] * w, device)}


def x_pool(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The pool of hidden states, (pool, batch, hidden) fp32: N(0, 1)
    times a per-token scale, uniform(0.5, 2)."""
    g = generator(device, seed, 2)
    shape = (traffic["pool"], traffic["batch"], cfg["hidden_size"])
    x = torch.randn(shape, generator=g, device=device)
    scale = torch.rand(shape[:2] + (1,), generator=g, device=device)
    return x.mul_(scale.mul_(1.5).add_(0.5))


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def top_weights(cfg: dict, s: torch.Tensor, idx: torch.Tensor):
    """The routing weights (B, E) on the experts ``idx`` (B, k) of scores
    ``s``, by the configuration's rule."""
    top = s.gather(1, idx)
    if cfg["norm_topk_prob"] and idx.shape[1] > 1:
        top = top / (top.sum(-1, keepdim=True) + 1e-20)
    else:
        top = top * cfg["routed_scaling_factor"]
    return torch.zeros_like(s).scatter_(1, idx, top)


def mlp(u, w, rnd=lambda t: t):
    """``MLP(u)`` of the triple ``w``, each product's operands through
    ``rnd`` (the control's TF32 rounding)."""
    g, v, d = w
    u = rnd(u)
    return rnd(torch.nn.functional.silu(u @ g) * (u @ v)) @ d


def mlp_scaled(u: torch.Tensor, w) -> tuple[torch.Tensor, torch.Tensor]:
    """``MLP(u)`` in float64 and its scale: the reference propagated in
    absolute values (``|u|`` through ``|G|`` and ``|U|``, the SwiGLU's
    terms, ``|D|``), which bounds what rounding each product's terms can
    move."""
    g, v, d = (t.double() for t in w)
    a, b = u @ g, u @ v
    sa, sb = u.abs() @ g.abs(), u.abs() @ v.abs()
    act = torch.nn.functional.silu(a)
    h = act * b
    hs = act.abs() * sb + SILU_SLOPE * sa * b.abs() + h.abs()
    return h @ d, hs @ d.abs()


def layer_counts(cfg: dict, p: dict, pool: torch.Tensor) -> dict:
    """What one layer call needs on each pool entry, counted from the
    problem and not from a format: ``bytes`` (4 B a stored value the call's
    products touch, the dense router, x in and y out once; for a MoE layer,
    h in and out once), ``flops`` (2 per stored value and token that uses
    it) and, for a MoE layer, ``routed_bytes``: the routed experts' part,
    4 B a stored value of G, U and D of every expert some token routes to,
    by the float64 routing, h in and out, u in and y out."""
    nnz = lambda w: sum(int((t != 0).sum()) for t in w)  # noqa: E731
    n, b, hidden = pool.shape
    io = 2 * 4 * b * hidden
    if "mlp" in p:
        z = nnz(p["mlp"])
        return {"bytes": [4 * z + io] * n, "flops": [2 * z * b] * n}
    e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    per = torch.tensor([nnz(t) for t in p["experts"]], dtype=torch.float64,
                       device=pool.device)
    shared = nnz(p["shared"])
    s = scores(p, normed(cfg, p, pool)).view(n * b, e)
    idx = s.topk(cfg["num_experts_per_tok"], dim=-1).indices
    routed = torch.zeros_like(s, dtype=torch.bool).scatter_(1, idx, True) \
        .view(n, b, e)
    live = routed.any(dim=1).double() @ per                     # (n,)
    uses = routed.double().sum(dim=1) @ per                     # (n,)
    h = 2 * 4 * b * e * w
    rb = [int(4 * v + h + io) for v in live.tolist()]
    fixed = 4 * (shared + hidden * e)
    flops = [int(2 * (v + b * (shared + hidden * e))) for v in uses.tolist()]
    return {"bytes": [r + fixed for r in rb], "routed_bytes": rb,
            "flops": flops}


def normed(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """``u = RMSNorm(x)`` in float64."""
    return rms_norm(x.double(), p["norm"].double(), cfg["rms_norm_eps"])


def scores(p: dict, u: torch.Tensor) -> torch.Tensor:
    """``s = softmax(u R)`` in float64, (N, E)."""
    return torch.softmax(u @ p["router"].double(), dim=-1)


def answer(cfg: dict, p: dict, u: torch.Tensor, idx=None):
    """The layer's answer to normed u (N, hidden) in float64, its scale,
    and for a MoE layer the routing weights (N, E) used: on the experts
    ``idx`` (N, k), or where None the float64 top k."""
    if "mlp" in p:
        y, ys = mlp_scaled(u, p["mlp"])
        return y, ys, None
    s = scores(p, u)
    if idx is None:
        idx = s.topk(cfg["num_experts_per_tok"], dim=-1).indices
    weights = top_weights(cfg, s, idx)
    # the routing's rounding: a score moves by about s_e (|dl_e| + max
    # |dl|), each logit's error dl within (|u| |R|) times the unit rounding
    ls = u.abs() @ p["router"].double().abs()
    rs = weights * (ls + ls.max(dim=1, keepdim=True).values)
    y, ys = mlp_scaled(u, p["shared"])
    for e, w in enumerate(p["experts"]):
        live = weights[:, e] != 0
        if not live.any():
            continue
        ye, yse = mlp_scaled(u[live], w)
        y[live] += weights[live, e:e + 1] * ye
        ys[live] += weights[live, e:e + 1] * yse \
            + rs[live, e:e + 1] * ye.abs()
    return y, ys, weights


class Control:
    """The control: the reference in the program's place, each product's
    operands rounded to TF32 (10 mantissa bits) and summed in float32, as
    a TF32 tensor-core product computes, expert by expert. The
    configuration states float32 with TF32 off, so this is the nearest
    precision below it."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        no_tf32()

    def pack(self, layer: int, p: dict, batch: int, device):
        rnd = lambda w: tuple(tf32(t) for t in w)  # noqa: E731
        if "mlp" in p:
            return {"norm": p["norm"], "mlp": rnd(p["mlp"])}
        return {"norm": p["norm"], "router": tf32(p["router"]),
                "experts": [rnd(w) for w in p["experts"]],
                "shared": rnd(p["shared"])}

    def layer(self, q: dict, x: torch.Tensor):
        cfg = self.cfg
        u = rms_norm(x, q["norm"], cfg["rms_norm_eps"])
        if "mlp" in q:
            return mlp(u, q["mlp"], tf32), None
        s = torch.softmax(tf32(u) @ q["router"], dim=-1)
        weights = top_weights(cfg, s, s.topk(cfg["num_experts_per_tok"],
                                             dim=-1).indices)
        y = mlp(u, q["shared"], tf32)
        for e, w in enumerate(q["experts"]):
            y = y + weights[:, e:e + 1] * mlp(u, w, tf32)
        return y, weights

    def route(self, q) -> str:
        return "control: dense TF32, expert by expert"

    def counters(self, q) -> dict:
        return {}
