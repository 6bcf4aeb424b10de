"""Scaling efficiency of the sharded maps over D ranks.

Counterpart of ``tpusparse/bench/scaling.py``. Each point runs the public
sharded call (``parallel.spmv_sharded`` for ``dense``,
``parallel.sparse.sell_spmm_sharded`` for ``sell``) in a world of D ranks:
``sweep_scaling`` runs inside a started world (``parallel.initialize``,
every rank calling it) and takes, for each D, the mesh of ranks 0 .. D-1,
which run the point while the others wait. Operands are made from the same
seed on every rank, and placed on the rank's device once, before the
timed calls: a SELL point uploads the rank's shard (its first call), a
dense point uploads A (``spmv_sharded`` then takes the rank's slab as a
view on the device), so no timed call moves an operand from the host.

Timing: CUDA events on a card (``bench.runner.device_time``, with the
sharded calls' longer spin, ``shard_overhead.SPIN``), wall time between
barriers under gloo on the CPU; the median of ``reps`` calls on rank 0. A
point over gloo checks the program, not speed: the ranks share one host's
cores. The JAX package's tunnel slope (``k1``, ``k2``) has no counterpart.

Definitions (D = ranks, T_D = time of one call at D, D0 = the first count):
- weak scaling: per-rank work held constant (the sharded dimension grows
  with D); efficiency_D = T_D0 / T_D (ideal 1.0);
- strong scaling: total work held constant; efficiency_D = (D0 T_D0) /
  (D T_D) (ideal 1.0).

``python -m tpusparse_torch.bench.scaling --world D`` starts D ranks on
this host (rank r on ``cuda:r`` over NCCL, or ``--device cpu`` for gloo),
sweeps every count up to D that the partition can split, and prints the
points as one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

_LANES = 128


@dataclasses.dataclass
class ScalePoint:
    devices: int
    m: int
    n: int
    seconds: float
    efficiency: float | None = None

    def __str__(self) -> str:
        eff = "" if self.efficiency is None else \
            f" | eff {self.efficiency * 100:.0f}%"
        return (f"D={self.devices} ({self.m}x{self.n}): "
                f"{self.seconds * 1e6:.0f} us{eff}")


def _prepare(a: np.ndarray, x: np.ndarray, mesh, partition: str,
             kernel: str) -> Callable[[], torch.Tensor]:
    """The point's call on ``mesh``, with x on the rank's device."""
    from tpusparse_torch.parallel.mesh import mesh_device

    dev = mesh_device(mesh)
    xt = torch.from_numpy(x).to(dev)
    if kernel == "sell":
        from tpusparse_torch.formats import SellMatrix
        from tpusparse_torch.parallel.sparse import sell_spmm_sharded

        s = SellMatrix.from_dense(a, device="cpu")     # the host pack
        return lambda: sell_spmm_sharded(s, xt, mesh, partition)
    if kernel == "dense":
        from tpusparse_torch.parallel import spmv_sharded

        at = torch.from_numpy(a).to(dev)
        return lambda: spmv_sharded(at, xt, mesh, partition)
    raise ValueError(f"unknown kernel {kernel!r}")


def _time(fn: Callable[[], Any], dev: torch.device, group,
          reps: int) -> float:
    if dev.type == "cuda":
        from tpusparse_torch.bench.runner import device_time
        from tpusparse_torch.bench.shard_overhead import SPIN

        return device_time(fn, reps=reps, spin=SPIN).seconds
    times = []
    for _ in range(reps):
        dist.barrier(group=group)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _counts(mode: str, kernel: str, partition: str, base_m: int,
            base_n: int, world: int) -> tuple[int, ...]:
    """The powers of two up to the world that the partition can split (in
    strong mode the sharded dimension is fixed)."""
    def fits(d: int) -> bool:
        if mode == "weak":
            return True
        quantum = _LANES if kernel == "sell" else 1
        if partition == "ring":
            return (base_n // quantum) % d == 0 and \
                (base_m // quantum) % d == 0
        sharded = base_n if partition == "n" else base_m
        return (sharded // quantum) % d == 0 and sharded % d == 0

    return tuple(d for d in (1, 2, 4, 8, 16, 32) if d <= world and fits(d))


def sweep_scaling(*, mode: str = "weak", kernel: str = "dense",
                  partition: str = "n", base_m: int = 1024,
                  base_n: int = 1024, density: float = 0.5,
                  device_counts: tuple[int, ...] | None = None,
                  seed: int = 0, verbose: bool = True,
                  reps: int = 5) -> list[ScalePoint]:
    """Time the sharded call at each D of ``device_counts`` (default: every
    count the partition can split, up to the world). Every rank of the
    started world calls it and gets the same points (rank 0's times)."""
    from torch.distributed.device_mesh import DeviceMesh

    from tpusparse_torch.parallel import launch
    from tpusparse_torch.testing import generators

    if mode not in ("weak", "strong"):
        raise ValueError(f"unknown mode {mode!r}")
    world, me = dist.get_world_size(), dist.get_rank()
    dev = launch.device()
    if device_counts is None:
        device_counts = _counts(mode, kernel, partition, base_m, base_n,
                                world)
    if max(device_counts) > world:
        raise ValueError(f"device counts {device_counts} exceed the world "
                         f"of {world}")
    points: list[ScalePoint] = []
    for d in device_counts:
        if mode == "weak":          # grow the sharded dim with D
            m, n = (base_m, base_n * d) if partition == "n" \
                else (base_m * d, base_n)
        else:
            m, n = base_m, base_n
        mesh = DeviceMesh(dev.type, list(range(d)), mesh_dim_names=("n",))
        seconds = [0.0]
        if me < d:
            a = generators.random_sparse_matrix(m, n, density=density,
                                                seed=seed)
            x = generators.random_sparse_vector(m, density=density,
                                                seed=seed)
            fn = _prepare(a, x, mesh, partition, kernel)
            fn()                    # a SELL rank uploads its shard here
            seconds = [_time(fn, dev, mesh.get_group("n"), reps)]
        dist.broadcast_object_list(seconds, src=0)
        points.append(ScalePoint(devices=d, m=m, n=n, seconds=seconds[0]))
    d0, t0 = points[0].devices, points[0].seconds
    for p in points:
        p.efficiency = t0 / p.seconds if mode == "weak" \
            else (d0 * t0) / (p.devices * p.seconds)
    if verbose and me == 0:
        for p in points:
            print(f"[{mode}/{kernel}/{partition}] {p}")
        if dev.type == "cpu":
            print("note: the ranks share one host's cores over gloo; these "
                  "points check the sharded program, not its scaling")
    return points


def _rank_main(args) -> int:
    from tpusparse_torch.parallel import initialize

    initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
               device=None if args.device == "cuda" else args.device)
    pts = sweep_scaling(mode=args.mode, kernel=args.kernel,
                        partition=args.partition, base_m=args.base_m,
                        base_n=args.base_n, density=args.density,
                        reps=args.reps, verbose=False)
    if args.rank == 0:
        print(json.dumps({"scaling": [dataclasses.asdict(p) for p in pts],
                          "mode": args.mode, "kernel": args.kernel,
                          "partition": args.partition,
                          "device": args.device, "world": args.world}))
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="sharded scaling sweep on "
                                 "WORLD ranks of this host")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mode", default="weak", choices=("weak", "strong"))
    ap.add_argument("--kernel", default="sell", choices=("sell", "dense"))
    ap.add_argument("--partition", default="n",
                    choices=("n", "m", "ring"))
    ap.add_argument("--base-m", type=int, default=4096)
    ap.add_argument("--base-n", type=int, default=4096)
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:r, NCCL) or cpu (gloo)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"scaling: {args.world} ranks need {args.world} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.device == "cuda":       # build once here, not once a rank
        from tpusparse_torch.kernels import _build

        _build.build()
    from tpusparse_torch.parallel.launch import spawn_local

    try:
        logs = spawn_local("tpusparse_torch.bench.scaling",
                           list(argv if argv is not None else sys.argv[1:]),
                           args.world)
    except RuntimeError as e:
        print(f"scaling: {e}", file=sys.stderr)
        return 1
    print(logs[0].strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
