"""Ragged sharding: RSELL shards balanced by their stored chunks, over a
mesh whose rank count need not divide the column groups.

Counterpart of ``examples/05_ragged_sharding.py``; runs through
``parallel.launch`` at ``world=1`` in this process, or on ``world`` ranks
(two gloo ranks on the CPU with ``device="cpu"``).
Run: ``python -m tpusparse_torch.examples.ex05_ragged_sharding [--cpu]
[--world 2]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch.distributed as dist

from tpusparse_torch.examples import check, rank_world, run
from tpusparse_torch.testing import generators, reference


def _rank() -> dict:
    from tpusparse_torch.formats.rsell import RsellMatrix, rsell_shard_pack
    from tpusparse_torch.formats.sell import SellMatrix
    from tpusparse_torch.parallel import global_mesh
    from tpusparse_torch.parallel.sparse import rsell_spmm_sharded

    d = dist.get_world_size()
    mesh = global_mesh()
    m, n = 1024, 1280                       # 10 column groups: 10 % d != 0
    a = generators.random_sparse_matrix(m, n, density=0.2, seed=0,
                                        distribution="powerlaw")
    x = generators.random_sparse_vector(m, density=0.5, seed=0)
    y_ref = reference.sgemv_cpu(x, a)

    sell_mb = SellMatrix.from_dense(a, device="cpu").device_bytes() / 1e6
    rsell_mb = RsellMatrix.from_dense(a, device="cpu").device_bytes() / 1e6
    print(f"one-rank bytes: SELL {sell_mb:.1f} MB vs RSELL {rsell_mb:.1f} MB "
          f"(per-tile widths)")
    errs = {}
    for assignment in ("sorted", "balance"):
        shards = rsell_shard_pack(a, d, assignment=assignment)
        y = rsell_spmm_sharded(shards, x, mesh)
        errs[assignment] = float(np.abs(y.cpu().numpy() - y_ref).max())
        print(f"[{assignment:8s}] {shards}  max|err|={errs[assignment]:.2e}")
    check(max(errs.values()) <= 1e-3, f"errors {errs}")
    return dict(world=d, sell_mb=sell_mb, rsell_mb=rsell_mb, errs=errs)


def main(device=None, world: int = 1, rank: int | None = None,
         port: int | None = None) -> dict:
    return rank_world("tpusparse_torch.examples.ex05_ragged_sharding", _rank,
                      device, world, rank, port)


if __name__ == "__main__":
    sys.exit(run(main, ranks=True))
