"""The sharded layer's cost at world size 1 on one card.

Counterpart of ``tpusparse/bench/shard_overhead.py``: one card cannot time
multi-rank scaling, but it can time the sharded code path itself (the
rank's shard lookup, padding, halo strips, the gather of the full y) on a
mesh of one rank, against the unsharded public call on the same operands.
Three families, on the JAX file's own workloads and seeds:

- SELL, n partition: 4096^2, d = 0.5, seed 5;
- DIA, halo partition: the 512^2 5-point Laplacian (64^2 with
  ``--quick``), K8 with its halo strips on the JAX package's slab width;
- TCSR, n partition: 4096^2, 35% of the 128^2 tiles kept, 40% fill.

Two times a call: the device's, from ``bench.runner.device_time`` (CUDA
events around each call after a read-only L2 flush and a ~0.5 ms spin
kernel, so that the host has enqueued the whole call first; the median of
20), and the wall time of calls run back to back (``call_us``), which
shows the host's cost where it exceeds the device's. The sharded maps
return the full y, gathered over the group: at one rank that gather moves
nothing; on more ranks it has no TPU counterpart in bytes (the JAX package
left its output sharded).

Run on the card: ``python -m tpusparse_torch.bench.shard_overhead
[--quick] [--json PATH]``. It starts a world of one rank over NCCL.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any

import numpy as np
import torch

from tpusparse_torch.bench.roofline import card_info, format_bytes
from tpusparse_torch.bench.runner import device_time
from tpusparse_torch.testing import generators

# the spin before each timed call (~0.5 ms): the sharded calls' host code
# takes longer to enqueue than the runner's default covers, and the device
# time must not count the device waiting for it
SPIN = 1_000_000


def call_us(fn, calls: int = 200) -> float:
    """Wall µs a call when ``calls`` calls run back to back and one
    synchronise ends them: the larger of the host's time to enqueue a call
    and the device's to run it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _pair(name, run_unsharded, run_sharded, nbytes, nnz, quick,
          verbose=True) -> dict[str, Any]:
    kw = dict(warmup=2, reps=5) if quick else {}
    r0 = device_time(run_unsharded, name=f"{name} unsharded",
                     bytes_moved=nbytes, nnz=nnz, spin=SPIN, **kw)
    r1 = device_time(run_sharded, name=f"{name} sharded@1",
                     bytes_moved=nbytes, nnz=nnz, spin=SPIN, **kw)
    ratio = r1.seconds / r0.seconds
    c0, c1 = call_us(run_unsharded), call_us(run_sharded)
    if verbose:
        print(f"  {r0}\n  {r1}  -> ratio {ratio:.3f}; back to back "
              f"{c0:.1f} / {c1:.1f} us a call", file=sys.stderr)
    return dict(unsharded_us=r0.seconds * 1e6, sharded_us=r1.seconds * 1e6,
                ratio=ratio, unsharded_call_us=c0, sharded_call_us=c1,
                call_ratio=c1 / c0)


def tcsr_blocks(m: int = 4096, n: int = 4096) -> np.ndarray:
    """The JAX file's TCSR workload: 35% of the 128^2 tiles kept, 40% fill
    within them, seed 7."""
    rng = np.random.default_rng(7)
    keep = rng.random((m // 128, n // 128)) < 0.35
    keep.flat[0] = True
    mask = np.kron(keep, np.ones((128, 128), bool)) & \
        (rng.random((m, n)) < 0.4)
    ab = (rng.uniform(-1, 1, (m, n)) * mask).astype(np.float32)
    return np.where(mask & (ab == 0), 1e-3, ab).astype(np.float32)


def run(mesh=None, quick: bool = False, verbose: bool = True
        ) -> dict[str, Any]:
    """The three pairs on ``mesh`` (None: a world of one rank over NCCL,
    started here, and its mesh ``{"n": 1}``)."""
    from tpusparse_torch.formats import DiaMatrix, SellMatrix, TcsrMatrix
    from tpusparse_torch.parallel import initialize, make_mesh
    from tpusparse_torch.parallel.mesh import axis_size, mesh_device
    from tpusparse_torch.parallel.sparse import (dia_spmm_sharded,
                                                 sell_spmm_sharded,
                                                 tcsr_shard_pack,
                                                 tcsr_spmm_sharded)

    if mesh is None:
        initialize()
        mesh = make_mesh({"n": 1})
    if axis_size(mesh, "n") != 1:
        raise ValueError("shard_overhead times a mesh of one rank")
    dev = mesh_device(mesh)
    out: dict[str, Any] = dict(card=card_info()["line"], devices=1,
                               device=torch.cuda.get_device_name(dev))

    m = n = 4096
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=5)
    x = torch.from_numpy(generators.random_sparse_vector(m, 0.5, 5)).to(dev)
    s_host = SellMatrix.from_dense(a, device="cpu")
    s = SellMatrix.from_dense(a, device=dev)
    out["sell"] = _pair(
        "sell", lambda: s.spmv(x),
        lambda: sell_spmm_sharded(s_host, x, mesh, "n"),
        format_bytes(s), s.nnz, quick, verbose)

    c = generators.stencil_csr((64, 64) if quick else (512, 512))
    d_host = DiaMatrix.from_csr(c, device="cpu")
    d = DiaMatrix.from_csr(c, device=dev)
    xd = torch.from_numpy(generators.random_sparse_vector(c.shape[0], 0.5,
                                                          6)).to(dev)
    out["dia"] = _pair(
        "dia", lambda: d.spmv(xd),
        lambda: dia_spmm_sharded(d_host, xd, mesh, "halo"),
        format_bytes(d), c.nnz, quick, verbose)

    ab = tcsr_blocks(m, n)
    t = TcsrMatrix.from_dense(ab, device=dev)
    packed = tcsr_shard_pack(ab, 1)
    xb = torch.from_numpy(generators.random_sparse_vector(m, 0.5, 7)).to(dev)
    out["tcsr"] = _pair(
        "tcsr", lambda: t.spmv(xb),
        lambda: tcsr_spmm_sharded(packed, xb, mesh),
        format_bytes(t), t.nnz, quick, verbose)

    out["worst_ratio"] = max(out[k]["ratio"] for k in ("sell", "dia",
                                                        "tcsr"))
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--json", default=None, help="also write the record here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("shard_overhead: needs a CUDA card", file=sys.stderr)
        return 2
    rec = run(quick=args.quick)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
