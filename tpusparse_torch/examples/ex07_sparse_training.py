"""Sparse-weight training: the mask stays frozen, the values train.

``trainable_linear`` keeps A's values in two tied layouts (forward and
transpose); the backward runs K1 through the transpose for dx and K10 for
both value gradients, and pad slots get exactly zero gradient.
Counterpart of ``examples/07_sparse_training.py``.
Run: ``python -m tpusparse_torch.examples.ex07_sparse_training [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusparse_torch import trainable_linear
from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import resolve_device


def main(device=None, steps: int = 60) -> dict:
    dev = resolve_device(device)
    m, n = 1024, 512
    rng = np.random.default_rng(0)
    a0 = generators.random_sparse_matrix(m, n, density=0.1, seed=0)
    apply, params, masks, resync = trainable_linear(CsrMatrix.from_dense(a0),
                                                    device=dev)
    mask = masks["vals"]
    print(f"trainable slots: {int(mask.sum())} of {mask.numel()} "
          f"({float(mask.float().mean()) * 100:.0f}%: the rest are layout "
          f"padding; the transpose twin doubles value memory)")

    # regression target from a hidden dense teacher
    teacher = rng.standard_normal((m, n)).astype(np.float32) * 0.1
    xs = generators.random_sparse_batch(32, m, density=0.5, seed=1)
    ys = torch.from_numpy(xs @ teacher).to(dev)
    xs = torch.from_numpy(xs).to(dev)
    targets = [params["vals"], params["vals_t"]]
    losses = []
    for i in range(steps):
        loss = torch.mean((apply(params, xs) - ys) ** 2)
        grads = torch.autograd.grad(loss, targets)
        with torch.no_grad():
            for p, g in zip(targets, grads):
                p -= 2.0 * g
        losses.append(float(loss.detach()))
        if i % 15 == 0 or i == steps - 1:
            print(f"step {i:3d}: mse {losses[-1]:.5f}")
    resync(params)            # re-tie vals_t to vals exactly

    # gradient updates never touch pad slots
    off_mask = float(torch.where(mask, 0.0, params["vals"].detach())
                     .abs().max())
    print(f"max |pad slot| after training: {off_mask:.1e} (exactly 0.0)")
    check(off_mask == 0.0, f"a pad slot moved: {off_mask}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    return dict(mse_first=losses[0], mse_last=losses[-1], off_mask=off_mask)


if __name__ == "__main__":
    sys.exit(run(main))
