"""A sparse mixture-of-experts layer: SELL up-projection, a top-1 gate,
and an AWSP down-projection that reads only the routed experts' blocks.

Counterpart of ``examples/04_sparse_moe_layer.py``.
Run: ``python -m tpusparse_torch.examples.ex04_sparse_moe_layer [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np

from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.testing import generators

EXPERTS, H, D, B = 8, 512, 2048, 4


def main(device=None) -> dict:
    rng = np.random.default_rng(0)
    w1 = generators.random_sparse_matrix(D, EXPERTS * H, density=0.3, seed=1)
    w2 = generators.random_sparse_matrix(EXPERTS * H, D, density=0.3, seed=2)
    x = rng.uniform(-1, 1, (B, D)).astype(np.float32)

    w1_sell = SellMatrix.from_dense(w1, device=device)
    # g = H/128: one window group per expert block
    w2_awsp = AwspMatrix.from_dense(w2, g=H // 128, device=device)
    print(f"W1 packed: {w1_sell!r}\nW2 packed: {w2_awsp!r}")

    h = np.maximum(w1_sell.spmm(x).cpu().numpy(), 0.0)     # (B, E*H) relu

    # gate: keep each sample's strongest expert block, zero the rest
    norms = h.reshape(B, EXPERTS, H).sum(axis=2)
    top = norms.argmax(axis=1)
    mask = np.zeros((B, EXPERTS), np.float32)
    mask[np.arange(B), top] = 1.0
    h_gated = (h.reshape(B, EXPERTS, H) * mask[:, :, None]).reshape(B, -1)
    print(f"batch routed to experts {sorted(set(top.tolist()))} "
          f"of {EXPERTS}")

    plan = w2_awsp.plan(h_gated)
    print(f"AWSP plan: {plan.size}/{w2_awsp.n_groups} expert blocks read "
          f"({w2_awsp.device_bytes(h_gated) / 1e6:.1f} of "
          f"{w2_awsp.device_bytes() / 1e6:.1f} MB)")

    y = w2_awsp.spmm(h_gated).cpu().numpy()
    y_ref = h_gated.astype(np.float64) @ w2.astype(np.float64)
    err = float(np.abs(y - y_ref).max())
    print(f"layer output max|err| = {err:.2e} (contract: <= 1e-3)")
    check(err <= 1e-3, f"error {err} > 1e-3")
    return dict(experts=sorted(set(top.tolist())), blocks=int(plan.size),
                err=err)


if __name__ == "__main__":
    sys.exit(run(main))
