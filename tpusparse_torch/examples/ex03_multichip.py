"""Sharded SpMV over a mesh of ranks: SELL under the n, m and ring
partitions, and dense under the ring.

Counterpart of ``examples/03_multichip.py``: one process a rank over
``torch.distributed`` (``parallel.launch``). At ``world=1`` it runs in this
process; ``world=2`` with ``device="cpu"`` starts two gloo ranks on this
host (on cards, NCCL with rank r on ``cuda:r``).
Run: ``python -m tpusparse_torch.examples.ex03_multichip [--cpu]
[--world 2]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch.distributed as dist

from tpusparse_torch.examples import check, rank_world, run
from tpusparse_torch.testing import generators, reference


def _rank() -> dict:
    from tpusparse_torch.formats.sell import SellMatrix
    from tpusparse_torch.parallel import global_mesh, spmv_sharded
    from tpusparse_torch.parallel.sparse import sell_spmm_sharded

    d = dist.get_world_size()
    print(f"{d} ranks, {dist.get_backend()}")
    m = n = 512 * d
    a = generators.random_sparse_matrix(m, n, density=0.3, seed=0)
    x = generators.random_sparse_vector(m, density=0.5, seed=1)
    y_ref = reference.sgemv_cpu(x, a)

    mesh = global_mesh()
    s = SellMatrix.from_dense(a, device="cpu")      # each rank uploads its shard
    errs = {}
    for partition in ("n", "m", "ring"):
        y = sell_spmm_sharded(s, x, mesh, partition=partition)
        errs[f"sell[{partition}]"] = float(np.abs(y.cpu().numpy()
                                                  - y_ref).max())
    y = spmv_sharded(a, x, mesh=mesh, partition="ring")
    errs["dense[ring]"] = float(np.abs(y.cpu().numpy() - y_ref).max())
    for k, e in errs.items():
        print(f"{k:12s} max|err| = {e:.2e}")
    check(max(errs.values()) <= 1e-3, f"errors {errs}")
    return dict(world=d, errs=errs)


def main(device=None, world: int = 1, rank: int | None = None,
         port: int | None = None) -> dict:
    return rank_world("tpusparse_torch.examples.ex03_multichip", _rank,
                      device, world, rank, port)


if __name__ == "__main__":
    sys.exit(run(main, ranks=True))
