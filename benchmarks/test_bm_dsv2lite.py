"""The dsv2lite cell's check against its control and its faults, and its
counts by hand, on the CPU at a small size (hidden 256, 16 experts of
width 128, top 6, 2 shared, a dense layer of 320; one dense and two MoE
layers; 2 tokens a call, so that some experts go unrouted): the harness's
look for a card is skipped and the rest of a run is driven as it is on the
card. The program as it is comes out correct; the lower-precision control,
an answer altered in one expert's share, a forced route flip and an
answer left at zero come out not correct."""

import json

import pytest
import torch

from benchmarks import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
CELL = "dsv2lite.decode-b8"
SMALL = ({"hidden_size": 256, "moe_intermediate_size": 128,
          "n_routed_experts": 16, "intermediate_size": 320, "layers": 3},
         {"pool": 4, "batch": 2})
SEED = 2 ** 31 + 11
CFG = {**harness.load_json("configs", "dsv2lite"), **SMALL[0]}
ref = harness.load_module("reference", "dsv2lite")
driver = harness.load_module("configs", "dsv2lite")


def _run(system=None, trace=False):
    torch.set_num_threads(2)
    return harness.run_cell(BENCH, CELL, SEED, 0.2, trace, CPU,
                            system=system, cfg_over=SMALL[0],
                            traffic_over={**SMALL[1], "trace_steps": 2})


@pytest.mark.parametrize("trace", [False, True])
def test_program_is_correct(trace):
    line = _run(trace=trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["route_flips"]["value"] == 0
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["metrics"]["live_expert_share"]["value"] < 1


def test_control_is_not_correct():
    assert not _run(system=ref.Control(CFG))["correct"]


def _most_routed(p):
    """The expert the pool's tokens route to most, by the reference."""
    pool = ref.x_pool(CFG, SMALL[1], SEED, CPU)
    s = ref.scores(p, ref.normed(CFG, p, pool.view(-1, pool.shape[-1])))
    idx = s.topk(CFG["num_experts_per_tok"], dim=-1).indices
    return int(torch.bincount(idx.view(-1)).argmax())


class Altered(driver.Program):
    """One expert's D off by 1% in the packed stack, so that its share of
    each answer it takes part in is off."""

    def pack(self, layer, p, batch, device):
        m = super().pack(layer, p, batch, device)
        if isinstance(m, self.moe):
            e, g = _most_routed(p), m.down.g
            m.down.vals[:, e * g:(e + 1) * g] *= 1.01
        return m


class Flipped(driver.Program):
    """Each call's first token routed to its 7th expert in place of its
    1st, with the 7th's score as its weight."""

    def pack(self, layer, p, batch, device):
        m = super().pack(layer, p, batch, device)
        if isinstance(m, self.moe):
            route, k = m.route, m.top_k

            def flipped(u):
                w = route(u)
                s = torch.softmax(u @ m.router, dim=-1)
                top = s[0].topk(k + 1).indices
                w[0, top[0]], w[0, top[k]] = 0.0, s[0, top[k]]
                return w

            m.route = flipped
        return m


class Unchanged(driver.Program):
    def layer(self, m, x):
        y, w = super().layer(m, x)
        return torch.zeros_like(y), w


@pytest.mark.parametrize("fault", [Altered, Flipped, Unchanged],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    line = _run(system=fault(CFG))
    assert not line["correct"] and line["failed"] > 0
    if fault is Flipped:
        assert line["checks"]["route_flips"]["value"] > 0


def test_layer_counts_by_hand():
    cfg = {"n_routed_experts": 4, "moe_intermediate_size": 2,
           "num_experts_per_tok": 2, "rms_norm_eps": 1e-6,
           "norm_topk_prob": False, "routed_scaling_factor": 1}
    hidden = 2

    def expert(nz):           # G, U, D with nz, nz and 1 stored values
        g = torch.zeros(hidden, 2)
        g.view(-1)[:nz] = 1.0
        d = torch.zeros(2, hidden)
        d[0, 0] = 1.0
        return g, g.clone(), d

    # token 0 (x = (1, 0)) routes to experts 0 and 1, token 1 (x = (0, 1))
    # to 1 and 2: expert 3 is routed by neither
    router = torch.tensor([[9.0, 8.0, 0.0, -9.0], [0.0, 8.0, 9.0, -9.0]])
    p = {"norm": torch.ones(hidden), "router": router,
         "experts": [expert(nz) for nz in (1, 2, 3, 4)],
         "shared": expert(2)}
    pool = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])          # (1, B=2, 2)
    c = ref.layer_counts(cfg, p, pool)
    live = (2 * 1 + 1) + (2 * 2 + 1) + (2 * 3 + 1)            # experts 0-2
    h = 2 * 4 * 2 * 4 * 2                  # h (B x E w floats) in and out
    io = 2 * 4 * 2 * hidden                # x or u in, y out
    assert c["routed_bytes"] == [4 * live + h + io]
    assert c["bytes"] == [4 * live + h + io + 4 * ((2 * 2 + 1) + 2 * 4)]
    # each token uses its 2 experts, the shared one and the router
    uses = (2 * 1 + 1) + 2 * (2 * 2 + 1) + (2 * 3 + 1)
    assert c["flops"] == [2 * (uses + 2 * ((2 * 2 + 1) + 2 * 4))]
    dense = ref.layer_counts(cfg, {"norm": p["norm"], "mlp": expert(3)},
                             pool)
    assert dense == {"bytes": [4 * 7 + io], "flops": [2 * 7 * 2]}


def test_pruning_keeps_half_of_each_output():
    w = ref.prune(torch.randn(64, 24), 0.5)
    assert ((w != 0).sum(dim=0) == 32).all()
