"""Quickstart: pack a sparse matrix, run SpMV and SpMM on the card.

Counterpart of ``examples/01_quickstart.py``.
Run: ``python -m tpusparse_torch.examples.ex01_quickstart [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np

from tpusparse_torch import auto_format, matrix_stats, spmm, spmv
from tpusparse_torch.examples import check, run
from tpusparse_torch.testing import generators, reference


def main(device=None) -> dict:
    m, n = 2048, 1024
    a = generators.random_sparse_matrix(m, n, density=0.2, seed=0)
    x = generators.random_sparse_vector(m, density=0.5, seed=1)
    xb = generators.random_sparse_batch(4, m, density=0.5, seed=2)

    print("matrix stats:", matrix_stats(a))
    fmt = auto_format(a, device=device)           # SELL here
    print("auto_format picked:", type(fmt).__name__)

    y = spmv(fmt, x)
    yb = spmm(fmt, xb)
    err = float(np.abs(y.cpu().numpy() - reference.sgemv_cpu(x, a)).max())
    errb = float(np.abs(yb.cpu().numpy() - reference.sgemm_cpu(xb, a)).max())
    print(f"spmv max|err| = {err:.2e}, spmm max|err| = {errb:.2e} "
          f"(contract: <= 1e-3)")
    check(err <= 1e-3 and errb <= 1e-3, f"errors {err}, {errb} > 1e-3")
    return dict(format=type(fmt).__name__, err=err, errb=errb)


if __name__ == "__main__":
    sys.exit(run(main))
