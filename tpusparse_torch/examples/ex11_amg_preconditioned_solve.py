"""AMG-preconditioned CG on a 2-D Laplacian: smoothed aggregation built on
the host once, V-cycles on the card.

Counterpart of ``examples/11_amg_preconditioned_solve.py``.
Run: ``python -m tpusparse_torch.examples.ex11_amg_preconditioned_solve
[--cpu]``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tpusparse_torch.amg import smoothed_aggregation
from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.solve import cg
from tpusparse_torch.utils import resolve_device


def main(device=None, side: int = 128, tol: float = 1e-5) -> dict:
    from scipy import sparse as ssp

    dev = resolve_device(device)
    n = side * side
    t1d = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
    a = (ssp.kron(ssp.eye(side), t1d) + ssp.kron(t1d, ssp.eye(side))).tocsr()

    t0 = time.perf_counter()
    amg = smoothed_aggregation(CsrMatrix.from_scipy(a.astype(np.float32)),
                               device=dev)
    setup_s = time.perf_counter() - t0
    print(f"setup {setup_s:.2f} s\n  {amg!r}")

    b = torch.from_numpy(np.random.default_rng(0).normal(size=n)
                         .astype(np.float32)).to(dev)
    amg.solve(b, tol=tol)                       # warm
    t0 = time.perf_counter()
    z, info = amg.solve(b, tol=tol)
    res = float(info["resnorm"])                # reading it synchronises
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"AMG-CG: {info['iters']} iters, resnorm {res:.2e}, "
          f"{warm_ms:.1f} ms warm")

    _, plain = cg(amg.levels[0].apply_a, b, tol=tol, maxiter=20 * side)
    print(f"plain CG for the same tolerance: {plain['iters']} iters")
    err = float(np.abs(a @ z.double().cpu().numpy() - b.cpu().numpy()).max())
    print(f"max|Az - b| = {err:.2e}")
    check(err < 1e-3, f"max|Az - b| {err} >= 1e-3")
    check(info["iters"] < plain["iters"],
          f"AMG took {info['iters']} iterations, plain CG {plain['iters']}")
    return dict(iters=int(info["iters"]), plain_iters=int(plain["iters"]),
                err=err, setup_s=setup_s, warm_ms=warm_ms)


if __name__ == "__main__":
    sys.exit(run(main))
