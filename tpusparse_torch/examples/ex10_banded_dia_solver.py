"""An implicit convection-diffusion step: the router spots the band, DIA
(K8) applies the nonsymmetric operator, BiCGStab solves.

Counterpart of ``examples/10_banded_dia_solver.py``; its third step shards
the operator with the stencil halo over every visible device, which a
world of one rank leaves out, as the JAX example does on one device.
Run: ``python -m tpusparse_torch.examples.ex10_banded_dia_solver [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.auto import auto_format
from tpusparse_torch.formats.csr import CsrMatrix
from tpusparse_torch.formats.dia import DiaMatrix
from tpusparse_torch.solve import bicgstab
from tpusparse_torch.utils import resolve_device


def convection_diffusion(side: int, c: float = 0.4,
                         shift: float = 0.0) -> CsrMatrix:
    """``shift I + (-Laplacian + c d/dx)``, 5-point plus upwind, built as
    COO (never densified). The upwind term couples each node to its
    downstream neighbour only, so the operator S is not symmetric; this is
    the CSR of S.T, so that ``spmv(v) = v @ pack`` applies S."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    rows, cols = [np.arange(n)], [np.arange(n)]
    vals = [np.full(n, 4.0 + shift, np.float32)]
    for (di, dj) in ((0, 1), (1, 0)):
        src = idx[: side - di, : side - dj].ravel()
        dst = idx[di:, dj:].ravel()
        for (r, c_) in ((src, dst), (dst, src)):
            rows.append(r)
            cols.append(c_)
            vals.append(np.full(r.size, -1.0, np.float32))
    # upwind: S[i, i+1] -= c  ->  S.T entry (i+1, i)
    src = idx[:, : side - 1].ravel()
    rows.append(src + 1)
    cols.append(src)
    vals.append(np.full(src.size, -c, np.float32))
    # CSR of S.T: rows and cols swap roles in the COO build
    return CsrMatrix.from_coo(n, n, np.concatenate(cols),
                              np.concatenate(rows), np.concatenate(vals))


def main(device=None) -> dict:
    dev = resolve_device(device)
    side = 128
    n = side * side
    csr_st = convection_diffusion(side, shift=1.0)

    # 1. route: O(nnz) statistics on the CSR spot the band
    fmt = auto_format(csr_st, device=dev)
    check(isinstance(fmt, DiaMatrix), f"routed to {fmt!r}, not DIA")
    print(f"routed: {fmt}\n  offsets: {fmt.offsets} (5-point + upwind)")

    # 2. solve one implicit time step with BiCGStab
    rng = np.random.default_rng(0)
    u_true = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    b = fmt.spmv(u_true)                         # b = S u_true
    u, info = bicgstab(fmt, b, tol=1e-6, maxiter=n)
    err = float((u - u_true).abs().max())
    print(f"bicgstab: {info['iters']} iters, resnorm "
          f"{float(info['resnorm']):.2e}, max|err| {err:.2e}")
    check(err < 1e-3, f"error {err} >= 1e-3")
    return dict(offsets=list(fmt.offsets), iters=int(info["iters"]),
                err=err)


if __name__ == "__main__":
    sys.exit(run(main))
