"""Serving lanes: SELL with fp32, bf16 and int8 value storage.

Counterpart of ``examples/06_serving_quantized_tuned.py`` without its
``--tune`` step: the Pallas step geometry it sweeps has no meaning on the
card (the launch shape is chosen in ``kernels/_build.py:split_work``).
bf16 and int8 store the values only (fp32 sums; int8 with per-column
scales), so their errors lie outside the 1e-3 fp32 contract.
Run: ``python -m tpusparse_torch.examples.ex06_serving_quantized [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np

from tpusparse_torch.examples import check, run
from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.testing import generators


def main(device=None) -> dict:
    m = n = 2048
    a = generators.random_sparse_matrix(m, n, density=0.25, seed=0)
    x = generators.random_sparse_vector(m, density=0.5, seed=1)
    y_fp64 = x.astype(np.float64) @ a.astype(np.float64)

    out = {}
    for dtype, label in [(None, "fp32"), ("bfloat16", "bf16"),
                         ("int8", "int8 + per-column scales")]:
        fmt = SellMatrix.from_dense(a, dtype=dtype, device=device)
        y = fmt.spmv(x).cpu().numpy()
        err = float(np.max(np.abs(y - y_fp64)))
        out[label.split()[0]] = dict(mb=fmt.device_bytes() / 1e6, err=err)
        print(f"{label:>26}: {fmt.device_bytes() / 1e6:5.1f} MB, "
              f"max|err| {err:.2e}")
    check(out["fp32"]["err"] <= 1e-3, f"fp32 error {out['fp32']['err']}")
    check(out["bf16"]["mb"] < out["fp32"]["mb"]
          and out["int8"]["mb"] < out["bf16"]["mb"],
          f"the narrow lanes store no fewer bytes: {out}")
    fmt = SellMatrix.from_dense(a, dtype="int8", device=device)
    print("serving call:", fmt.spmv(x).cpu().numpy()[:4])
    return out


if __name__ == "__main__":
    sys.exit(run(main))
