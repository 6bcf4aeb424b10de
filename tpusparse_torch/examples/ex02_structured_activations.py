"""AWSP: weight and activation sparsity with a window-group plan made once.

A serving system with a fixed routing mask (MoE, padded batches,
block-ReLU) computes the plan once per mask; the kernel (K3) then never
reads the values of dead window groups. Counterpart of
``examples/02_structured_activations.py``.
Run: ``python -m tpusparse_torch.examples.ex02_structured_activations
[--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np

from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.testing import generators, reference


def main(device=None) -> dict:
    m = n = 4096
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=0)
    fmt = AwspMatrix.from_dense(a, g=8, device=device)   # skip 1024 rows

    x = generators.random_sparse_vector(m, density=0.5, seed=1).copy()
    x[1024:] = 0                               # only the first quarter live

    plan = fmt.plan(x)                         # host-side, O(M)
    print(f"plan: {plan.size}/{fmt.n_groups} window groups active")
    print(f"traffic: {fmt.device_bytes(x) / 1e6:.1f} MB of "
          f"{fmt.device_bytes() / 1e6:.1f} MB")

    y = fmt.spmv(x, plan=plan)                 # reuse the plan across calls
    err = float(np.abs(y.cpu().numpy() - reference.sgemv_cpu(x, a)).max())
    print(f"max|err| = {err:.2e} (contract: <= 1e-3)")
    check(err <= 1e-3, f"error {err} > 1e-3")
    return dict(active=int(plan.size), groups=fmt.n_groups,
                mb_live=fmt.device_bytes(x) / 1e6, err=err)


if __name__ == "__main__":
    sys.exit(run(main))
