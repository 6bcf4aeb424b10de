"""A sparse MLP in ``torch.nn``: a 90%-pruned ``SparseLinear`` hidden layer
(frozen mask, trainable values, K1 and K10) and a small dense head,
trained with ``torch.optim.Adam``.

Counterpart of ``examples/08_flax_sparse_mlp.py`` (flax and optax there).
Run: ``python -m tpusparse_torch.examples.ex08_sparse_mlp [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusparse_torch.examples import check, run
from tpusparse_torch.nn import SparseLinear
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import resolve_device


def main(device=None, steps: int = 40) -> dict:
    dev = resolve_device(device)
    d_in, d_hidden, d_out = 512, 1024, 64
    a0 = generators.random_sparse_matrix(d_in, d_hidden, density=0.1, seed=0)
    torch.manual_seed(0)
    hidden = SparseLinear.from_dense(a0, use_bias=True,
                                     activation=torch.relu, device=dev)
    model = torch.nn.Sequential(hidden, torch.nn.Linear(d_hidden, d_out)
                                .to(dev))

    rng = np.random.default_rng(0)
    xs = torch.from_numpy(generators.random_sparse_batch(
        64, d_in, density=0.5, seed=1)).to(dev)
    w_true = torch.from_numpy((rng.standard_normal((d_in, d_out)) * 0.05)
                              .astype(np.float32)).to(dev)
    ys = torch.tanh(xs @ w_true)

    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        loss = torch.mean((model(xs) - ys) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:3d}: mse {losses[-1]:.5f}")

    off = float(torch.where(hidden.masks["vals"], 0.0, hidden.vals.detach())
                .abs().max())
    print(f"hidden layer stays pruned: max |pad slot| = {off:.1e}")
    check(off == 0.0, f"a pad slot moved: {off}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    return dict(mse_first=losses[0], mse_last=losses[-1], off_mask=off)


if __name__ == "__main__":
    sys.exit(run(main))
