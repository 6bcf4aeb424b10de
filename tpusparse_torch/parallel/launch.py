"""Process launch: one process a rank, and each rank's slab of the
operand.

Counterpart of ``tpusparse/parallel/launch.py``. ``initialize()`` starts
``torch.distributed``'s default process group once a process, from the
environment a launcher such as ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or from its
arguments; with neither, this process alone is a world of 1 (an in-process
store, no socket). A rank runs on ``cuda:LOCAL_RANK`` over NCCL, unless the
caller passes ``backend="gloo"`` (its collectives then pass through host
memory, ``comm.py``) or ``device="cpu"`` (gloo on the CPU). Every rank
makes the same seeded global operand and slices its own slab
(``host_local_matrix``), so slabs tile one logical matrix.
``spawn_local`` starts a world of ranks on this host, one child process
each (``python -m MODULE ... --rank R --port P``).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from tpusparse_torch.utils import resolve_device

_DEVICE: list[torch.device] = []   # this process's rank device, once set


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               device: str | torch.device | None = None) -> torch.device:
    """Start the default process group (idempotent) and return this rank's
    device. ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` default to ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK``; ``device`` to ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` 0 when
    unset); ``backend`` to NCCL on a CUDA device, gloo on the CPU.

    A second call that asks for the world already started returns its
    device; one that asks for another world, rank, backend or device raises
    (a multi-process start after a world of 1 began here is too late)."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    world = num_processes if num_processes is not None else \
        _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    local = _env_int("LOCAL_RANK") or 0
    dev = resolve_device(device if device is not None else f"cuda:{local}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("initialize: NCCL needs a CUDA device")
    if dist.is_initialized():
        live = (dist.get_world_size(), dist.get_rank(),
                dist.get_backend(), _DEVICE[0] if _DEVICE else None)
        asked = (live[0] if world is None else world,
                 live[1] if rank is None else rank, backend, dev)
        if asked != live:
            raise RuntimeError(
                "tpusparse_torch.parallel.initialize() must be called once, "
                "before any other process group starts: the live group is "
                f"(world, rank, backend, device) {live}, the call asks for "
                f"{asked}")
        return _DEVICE[0]
    if world is None or world == 1:
        if coordinator_address is not None and world is None:
            raise ValueError("initialize: a coordinator address with no "
                             "world size (num_processes or WORLD_SIZE)")
        world, rank = 1, 0 if rank is None else rank
        if rank != 0:
            raise ValueError(f"initialize: rank {rank} in a world of 1")
        kw = dict(store=dist.HashStore())
    else:
        if coordinator_address is None or rank is None:
            raise ValueError(f"initialize: a world of {world} needs a "
                             "coordinator address and this process's rank")
        kw = dict(init_method=f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    _DEVICE[:] = [dev]
    return dev


def device() -> torch.device:
    """This rank's device (``initialize`` must have run)."""
    if not _DEVICE:
        raise RuntimeError("call tpusparse_torch.parallel.initialize() first")
    return _DEVICE[0]


def global_mesh(axis_name: str = "n"):
    """1-D mesh over every rank of the world."""
    from tpusparse_torch.parallel.mesh import make_mesh

    return make_mesh({axis_name: dist.get_world_size()})


def process_slab(m: int, n: int, *, partition: str = "n",
                 process_index: int | None = None,
                 process_count: int | None = None) -> tuple[slice, slice]:
    """This process's (row, col) slab of the global (m, n) operand: with
    ``partition='n'`` the processes split the output dim, with ``'m'`` the
    contraction dim. Raises where the split is uneven."""
    up = dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None \
        else process_count
    if partition == "n":
        if n % pc:
            raise ValueError(f"n={n} not divisible by {pc} processes")
        step = n // pc
        return slice(0, m), slice(pi * step, (pi + 1) * step)
    if partition == "m":
        if m % pc:
            raise ValueError(f"m={m} not divisible by {pc} processes")
        step = m // pc
        return slice(pi * step, (pi + 1) * step), slice(0, n)
    raise ValueError(f"unknown partition {partition!r}")


def host_local_matrix(m: int, n: int, *, density: float = 0.5, seed: int = 0,
                      partition: str = "n", distribution: str = "uniform",
                      **slab_kw) -> np.ndarray:
    """This process's slab of the seeded global matrix (the same seed on
    every process, so the slabs tile one logical matrix)."""
    from tpusparse_torch.testing import generators

    a = generators.random_sparse_matrix(m, n, density=density, seed=seed,
                                        distribution=distribution)
    rs, cs = process_slab(m, n, partition=partition, **slab_kw)
    return a[rs, cs]


def spawn_local(module: str, argv: list[str], world: int,
                timeout: float = 1800) -> list[str]:
    """Run ``python -m module *argv --rank r --port P`` for r in 0 .. world-1
    on this host (``LOCAL_RANK=r``, a free local port for the rank-0
    store) and return each rank's output. Every child has ended when it
    returns; raises ``RuntimeError`` with the log of a rank that failed."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--rank", str(r), "--port",
         str(port)], env={**env, "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{module}: rank {r} failed:\n{log[-3000:]}")
    return logs
