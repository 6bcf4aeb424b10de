"""A two-layer GCN on a two-community graph: ``H' = relu(W (H A_hat))``
through ``linear_map`` on the routed pack of the normalized adjacency,
trained by plain gradient descent.

Counterpart of ``examples/12_gcn_node_classification.py``.
Run: ``python -m tpusparse_torch.examples.ex12_gcn_node_classification
[--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusparse_torch.autodiff import linear_map
from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.auto import auto_format
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.graph import normalized_adjacency
from tpusparse_torch.utils import resolve_device


def stochastic_block_model(n, p_in, p_out, seed=0):
    """Undirected 2-community graph: (CsrMatrix, labels)."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) >= n // 2).astype(np.int64)
    ii, jj = np.triu_indices(n, k=1)
    same = labels[ii] == labels[jj]
    keep = rng.random(ii.size) < np.where(same, p_in, p_out)
    ii, jj = ii[keep], jj[keep]
    rows = np.concatenate([ii, jj])             # symmetrize
    cols = np.concatenate([jj, ii])
    return CsrMatrix.from_coo(n, n, rows, cols,
                              np.ones(rows.size, np.float32)), labels


def main(device=None, steps: int = 60) -> dict:
    dev = resolve_device(device)
    n, f0, hidden, n_class = 2048, 32, 64, 2
    csr, labels = stochastic_block_model(n, p_in=16 / n, p_out=2 / n)
    a_hat = normalized_adjacency(csr)
    # at a 64-wide batch the gather formats pay ~64x their bytes, so even a
    # 0.5%-dense adjacency routes to a dense-tile format here
    fmt = auto_format(a_hat, expect_batch=max(f0, hidden), device=dev)
    print(f"A_hat: n={n}, nnz={a_hat.nnz} -> {type(fmt).__name__}")
    apply_a = linear_map(fmt, csr=a_hat)          # differentiable H @ A_hat

    rng = np.random.default_rng(1)
    # noisy community-indicator features, channels first (F0, N)
    h0 = torch.from_numpy(
        (0.1 * rng.normal(size=(f0, n))
         + 0.3 * (rng.normal(size=(f0, 1)) * (2.0 * labels - 1.0)))
        .astype(np.float32)).to(dev)
    y = torch.from_numpy(labels).to(dev)
    train_mask = torch.from_numpy(rng.random(n) < 0.05).to(dev)
    print(f"labeled nodes: {int(train_mask.sum())}/{n}")
    params = {
        "w1": torch.from_numpy((rng.normal(size=(hidden, f0))
                                * np.sqrt(2.0 / f0)).astype(np.float32))
        .to(dev).requires_grad_(),
        "w2": torch.from_numpy((rng.normal(size=(n_class, hidden))
                                * np.sqrt(2.0 / hidden)).astype(np.float32))
        .to(dev).requires_grad_(),
    }

    def forward(p, h):
        z = torch.relu(p["w1"] @ apply_a(h))      # propagate, then mix
        return p["w2"] @ apply_a(z)               # logits (C, N)

    def loss_fn(p, h):
        logp = torch.log_softmax(forward(p, h), dim=0)
        nll = -logp.gather(0, y[None, :])[0]
        return torch.where(train_mask, nll, 0.0).sum() / train_mask.sum()

    def accuracy(p, h):
        with torch.no_grad():
            return float((forward(p, h).argmax(dim=0) == y).float().mean())

    loss0, acc0 = float(loss_fn(params, h0)), accuracy(params, h0)
    print(f"init: loss={loss0:.3f} acc={acc0:.3f}")
    for it in range(1, steps + 1):
        loss = loss_fn(params, h0)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= 0.5 * g
        if it % 20 == 0:
            print(f"step {it:3d}: loss={float(loss):.4f} "
                  f"acc(all nodes)={accuracy(params, h0):.3f}")
    loss1, acc1 = float(loss_fn(params, h0)), accuracy(params, h0)
    check(loss1 < loss0, f"the loss did not fall: {loss0} -> {loss1}")
    return dict(format=type(fmt).__name__, loss_init=loss0, loss=loss1,
                acc_init=acc0, acc=acc1)


if __name__ == "__main__":
    sys.exit(run(main))
