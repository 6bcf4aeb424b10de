"""Examples of the port, one module each, the counterparts of the JAX
package's ``examples/01..13``.

Each has ``main(device=None, ...)``, which runs on the card unless
``device="cpu"`` (the kernels' plain PyTorch versions), raises when a check
fails, and returns its checked numbers. Run one as
``python -m tpusparse_torch.examples.ex01_quickstart [--cpu]``; the
multi-rank ones (03, 05) also take ``--world N``.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Callable


def check(ok: bool, what: str) -> None:
    """Raise ``AssertionError(what)`` unless ``ok``."""
    if not ok:
        raise AssertionError(what)


def run(main: Callable[..., dict[str, Any]], argv=None,
        ranks: bool = False) -> int:
    """The command line of an example: ``--cpu``, and with ``ranks`` the
    world size and the spawned rank's own arguments. Prints ``main``'s
    result as one JSON line."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="the plain PyTorch versions on the CPU")
    if ranks:
        p.add_argument("--world", type=int, default=1)
        p.add_argument("--rank", type=int, default=None,
                       help=argparse.SUPPRESS)
        p.add_argument("--port", type=int, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    kw = dict(device="cpu" if args.cpu else None)
    if ranks:
        kw.update(world=args.world, rank=args.rank, port=args.port)
    print(json.dumps(main(**kw), default=float))
    return 0


def rank_world(module: str, rank_fn: Callable[[], dict[str, Any]],
               device, world: int, rank: int | None,
               port: int | None) -> dict[str, Any]:
    """A multi-rank example's body ``rank_fn`` on a world of ``world``
    ranks: at world 1 in this process (over the world already started, or
    a world of 1 that ends with the call); at more, ``world`` child
    processes on this host (gloo on the CPU, NCCL on the cards), whose
    rank 0 result is returned. ``rank``/``port`` mark a spawned child."""
    import torch.distributed as dist

    from tpusparse_torch.parallel.launch import initialize, spawn_local

    if world > 1 and rank is None:
        argv = ["--world", str(world)] + (["--cpu"] if device == "cpu"
                                          else [])
        logs = spawn_local(module, argv, world, timeout=600)
        return json.loads(logs[0].strip().splitlines()[-1])
    started = not dist.is_initialized()
    if rank is None:
        initialize(device=device)
    else:
        initialize(f"127.0.0.1:{port}", world, rank, device=device)
    try:
        return rank_fn()
    finally:
        if started:
            dist.destroy_process_group()
