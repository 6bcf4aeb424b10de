"""Prune a dense weight (magnitude, 2:4), multiply the pruned packs, then
solve a sparse SPD system with CG.

Counterpart of ``examples/09_prune_and_solve.py``.
Run: ``python -m tpusparse_torch.examples.ex09_prune_and_solve [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusparse_torch import magnitude_prune, nm_prune
from tpusparse_torch.bench.report import laplacian_2d
from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.prune import summary
from tpusparse_torch.solve import cg
from tpusparse_torch.utils import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)
    # 1. prune a "trained" dense weight
    rng = np.random.default_rng(0)
    w = rng.normal(size=(1024, 512)).astype(np.float32)
    out = {}
    for name, csr in [("magnitude 25% (per-column)", magnitude_prune(w, 0.25)),
                      ("2:4 structured", nm_prune(w, 2, 4))]:
        info = summary(csr)
        print(f"{name}: density {info['density']:.2f}, SELL W "
              f"{info['sell_w']}, padding {info['sell_pad_frac'] * 100:.1f}%")
        s = SellMatrix.from_csr(csr, device=dev)
        x = rng.normal(size=1024).astype(np.float32)
        y = s.spmv(x).cpu().numpy()
        ref = x.astype(np.float64) @ csr.to_dense().astype(np.float64)
        err = float(np.abs(y - ref).max())
        print(f"  spmv max|err| vs float64: {err:.2e}")
        check(err <= 1e-3, f"{name}: error {err} > 1e-3")
        out[name.split()[0]] = dict(density=info["density"], err=err)

    # 2. CG on a sparse SPD system
    side = 64                       # 4096 unknowns
    lap = laplacian_2d(side)
    s = SellMatrix.from_csr(lap, device=dev)    # symmetric: spmv(v) = L v
    print(f"\nLaplacian {lap.shape}, nnz {lap.nnz} "
          f"(density {lap.nnz / side ** 4 * 100:.2f}%)")
    z_true = torch.from_numpy(rng.normal(size=side * side)
                              .astype(np.float32)).to(dev)
    b = s.spmv(z_true)
    z, info = cg(s, b, tol=1e-5)
    rel = float(info["resnorm"]) / float(torch.linalg.norm(b))
    zerr = float((z - z_true).abs().max())
    print(f"CG: {info['iters']} iters, relative residual {rel:.2e}, "
          f"max|z - z_true| = {zerr:.2e}")
    check(rel <= 1e-5 * 1.01, f"CG stopped at relative residual {rel}")
    out["cg"] = dict(iters=int(info["iters"]), rel_residual=rel,
                     max_err=zerr)
    return out


if __name__ == "__main__":
    sys.exit(run(main))
