"""Serving with a changing activation pattern and no host planning: each
step's plan is made on the card (``csrc/group_plan.cu``), then K3 reads
only the live window groups.

On the card every step runs under ``torch.cuda.set_sync_debug_mode
("error")``: a step that synchronised with the host would raise.
Counterpart of ``examples/13_dynamic_serving.py``.
Run: ``python -m tpusparse_torch.examples.ex13_dynamic_serving [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.awsp import AwspMatrix
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import resolve_device

M = N = 1024
G = 2                       # windows per activation group
LIVE_GROUPS = 2             # groups live per serving step


def main(device=None) -> dict:
    dev = resolve_device(device)
    a = generators.random_sparse_matrix(M, N, density=0.4, seed=3)
    fmt = AwspMatrix.from_dense(a, g=G, device=dev)
    ng, span = fmt.n_groups, G * 128
    print(f"packed: {fmt!r} ({ng} activation groups)")

    rng = np.random.default_rng(7)
    errs = []
    for t in range(4):
        # a different sparse activation pattern every step (e.g. routing)
        live = rng.choice(ng, size=LIVE_GROUPS, replace=False)
        x = np.zeros(M, np.float32)
        for gi in live:
            x[gi * span:(gi + 1) * span] = rng.uniform(-1, 1, span)
        xt = torch.from_numpy(x).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.set_sync_debug_mode("error")
        try:
            y = fmt.spmv(xt, plan="device")
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        errs.append(float(np.max(np.abs(y.cpu().numpy() - x @ a))))
        print(f"step {t}: live groups {sorted(live.tolist())} -> "
              f"max|err| {errs[-1]:.2e} (no host planning)")
    check(max(errs) <= 1e-3, f"errors {errs}")
    return dict(groups=ng, errs=errs)


if __name__ == "__main__":
    sys.exit(run(main))
