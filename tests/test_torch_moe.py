"""``tpusparse_torch.moe`` against the plain reference
(``testing/moe_reference.py``) on the CPU, at a small size with the
published shape's features: hidden 256, 16 routed experts of width 128
(one 128-row AWSP window group an expert), top 6, 2 shared experts, and a
dense layer of width 320, which is not a multiple of 128. Weights are
seeded and pruned so that each output keeps exactly half of its inputs.

Tolerance: 1e-5 absolute against the float64 reference on outputs of
order 1. The port sums in float32 (each product over at most 6 * 128 + 256
terms of magnitude below 1, in another order than the reference), which
rounds by ~1e-6 at most here (5e-7 measured); a product that dropped or
doubled one stored value would move an output by ~1e-2. Routing weights are
softmax scores of order 1/16 from logits of order 1: 1e-6.
"""

import os
import subprocess
import sys

import pytest
import torch

from tpusparse_torch import moe
from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.testing import moe_reference as ref

HIDDEN, WIDTH, EXPERTS, TOP, SHARED, DENSE = 256, 128, 16, 6, 2, 320
CFG = {"hidden_size": HIDDEN, "intermediate_size": DENSE,
       "moe_intermediate_size": WIDTH, "n_routed_experts": EXPERTS,
       "num_experts_per_tok": TOP, "n_shared_experts": SHARED,
       "scoring_func": "softmax", "topk_method": "greedy",
       "norm_topk_prob": False, "routed_scaling_factor": 1,
       "rms_norm_eps": 1e-6, "hidden_act": "silu",
       "first_k_dense_replace": 1, "moe_layer_freq": 1}
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mat(g, rows, cols):
    return ref.prune_half(torch.randn(rows, cols, generator=g) / rows ** 0.5)


def _triple(g, width):
    return (_mat(g, HIDDEN, width), _mat(g, HIDDEN, width),
            _mat(g, width, HIDDEN))


def _weights(seed, dense=False):
    g = torch.Generator().manual_seed(seed)
    norm = 1 + 0.25 * torch.rand(HIDDEN, generator=g)
    if dense:
        return {"norm": norm, "mlp": _triple(g, DENSE)}
    return {"norm": norm,
            "router": torch.randn(HIDDEN, EXPERTS, generator=g)
            / HIDDEN ** 0.5,
            "experts": [_triple(g, WIDTH) for _ in range(EXPERTS)],
            "shared": _triple(g, SHARED * WIDTH)}


def _x(batch, seed=5):
    return torch.randn(batch, HIDDEN,
                       generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def layer():
    p = _weights(1)
    return p, moe.ffn_layer(CFG, 1, p, expect_batch=8, device="cpu")


def test_pruning_keeps_half_of_each_output():
    w = ref.prune_half(torch.randn(96, 40))
    assert ((w != 0).sum(dim=0) == 48).all()
    p = _weights(2)
    for t in (*p["experts"][3], *p["shared"]):
        assert ((t != 0).sum(dim=0) == t.shape[0] // 2).all()


def test_dense_layer_against_reference():
    p = _weights(3, dense=True)
    m = moe.ffn_layer(CFG, 0, p, expect_batch=8, device="cpu")
    assert isinstance(m, moe.SparseSwiGLU) and m.width == DENSE
    x = _x(8)
    assert (m(x).double() - ref.dense_layer(x, p, CFG)).abs().max() < TOL


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_moe_layer_against_reference(layer, batch):
    p, m = layer
    assert isinstance(m.gate_up, SellMatrix) and isinstance(m.down, AwspMatrix)
    assert m.gate_up.shape == (HIDDEN, 2 * EXPERTS * WIDTH)
    assert m.down.shape == (EXPERTS * WIDTH, HIDDEN) and m.down.g == 1
    x = _x(batch)
    y, w = m(x, with_weights=True)
    s, want = ref.route(ref.rms_norm(x.double(), p["norm"].double(), 1e-6),
                        p["router"].double(), CFG)
    assert torch.equal(w != 0, want != 0)
    assert (w.double() - want).abs().max() < 1e-6
    assert (y.double() - ref.moe_layer(x, p, CFG)).abs().max() < TOL


def test_live_groups_are_the_routed_experts(layer):
    """K3 reads the union of the routed experts, by the host plan of the
    layer's h and by the device counter, and no other."""
    p, m = layer
    x = _x(2, seed=9)
    before = m.counters()
    _, w = m(x, with_weights=True)
    union = torch.nonzero((w != 0).any(dim=0)).view(-1)
    assert 0 < len(union) < EXPERTS            # some experts unrouted
    u = moe.rms_norm(x, m.norm, m.eps)
    gv = m.gate_up.spmm(u)
    ew = EXPERTS * WIDTH
    h = (torch.nn.functional.silu(gv[:, :ew]) * gv[:, ew:]).view(
        2, EXPERTS, WIDTH) * w.unsqueeze(-1)
    assert m.down.plan(h.view(2, ew)).tolist() == union.tolist()
    after = m.counters()
    assert after["moe.calls"] == before["moe.calls"] + 1
    assert after["moe.live_groups"] - before["moe.live_groups"] == len(union)
    assert after["moe.experts"] == EXPERTS


@pytest.mark.parametrize("norm_topk", [False, True])
def test_norm_topk_prob_from_the_config(norm_topk):
    cfg = {**CFG, "norm_topk_prob": norm_topk, "routed_scaling_factor": 2.0}
    p = _weights(4)
    m = moe.ffn_layer(cfg, 1, p, device="cpu")
    x = _x(4)
    y, w = m(x, with_weights=True)
    sums = w.sum(dim=1).double()
    if norm_topk:
        assert (sums - 1).abs().max() < 1e-6
    else:
        s, _ = ref.route(ref.rms_norm(x.double(), p["norm"].double(), 1e-6),
                         p["router"].double(), cfg)
        top = s.topk(TOP, dim=1).values.sum(dim=1)
        assert (sums - 2.0 * top).abs().max() < 1e-6 and (sums < 2).all()
    assert (y.double() - ref.moe_layer(x, p, cfg)).abs().max() < TOL


def test_layer_kinds_follow_the_config():
    assert not moe.is_moe_layer(CFG, 0) and moe.is_moe_layer(CFG, 1)
    assert not moe.is_moe_layer({**CFG, "moe_layer_freq": 2}, 3)
    with pytest.raises(ValueError):
        moe.ffn_layer({**CFG, "scoring_func": "sigmoid"}, 1, _weights(1),
                      device="cpu")
    with pytest.raises(ValueError):
        moe.SparseMoE({**CFG, "moe_intermediate_size": 96}, _weights(1),
                      device="cpu")


def test_moe_module_imports_no_jax():
    code = ("import sys; import tpusparse_torch.moe, "
            "tpusparse_torch.testing.moe_reference; print(sorted({k.split('.')"
            "[0] for k in sys.modules} & {'jax', 'jaxlib', 'tpusparse', "
            "'flax'}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], check=True, env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]"
