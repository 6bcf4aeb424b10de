"""Device-time measurement on a CUDA card.

``device_time`` brackets each launch with a pair of CUDA events after a
warm-up and reports the median over the repetitions. Before every timed
launch it reads (sums) a 256 MB scratch buffer: the canonical operands
(57.7 MB SELL pack, 67 MB dense A) would otherwise sit partly in the H100's
50 MB L2 and read faster than the HBM they come from in real use. The flush
reads rather than writes: a written buffer leaves L2 full of dirty lines,
and their write-back then lands inside the timed call (measured at 7-8 us
on the SELL kernel, see PERF.md), a cost a caller whose previous calls only
read does not pay. After the flush it queues a short spin kernel, so the
host has enqueued the whole call before the device reaches the start
event: the Python wrappers cost about as much host time per call as their
kernels take on the device, and without the spin that host time could
show up as device time.

There is no CPU fallback: with no CUDA device it raises.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 200_000          # ~100 us at the H100's boost clock


@dataclasses.dataclass
class BenchResult:
    name: str
    seconds: float                  # median per-call device time
    bytes_moved: int | None = None  # format bytes actually streamed
    flops: int | None = None
    nnz: int | None = None
    device_kind: str | None = None

    @property
    def gbps(self) -> float | None:
        return None if self.bytes_moved is None else self.bytes_moved / self.seconds / 1e9

    @property
    def gflops(self) -> float | None:
        return None if self.flops is None else self.flops / self.seconds / 1e9

    @property
    def nnz_per_s(self) -> float | None:
        return None if self.nnz is None else self.nnz / self.seconds

    def __str__(self) -> str:
        parts = [f"{self.name}: {self.seconds*1e6:.1f} us"]
        if self.gbps is not None:
            parts.append(f"{self.gbps:.0f} GB/s")
        if self.gflops is not None:
            parts.append(f"{self.gflops:.1f} GFLOP/s")
        if self.nnz_per_s is not None:
            parts.append(f"{self.nnz_per_s/1e9:.2f} Gnnz/s")
        return " | ".join(parts)


def device_time(fn: Callable[..., Any], *args: Any, name: str = "kernel",
                bytes_moved: int | None = None, flops: int | None = None,
                nnz: int | None = None, warmup: int = 3,
                reps: int = 20, spin: int = SPIN_CYCLES) -> BenchResult:
    """Median per-call device seconds of ``fn(*args)`` over ``reps`` timed
    launches, each after an L2 flush and a ``spin``-cycle wait (raise it
    for a call whose host code takes longer than ~100 us to enqueue)."""
    _require_cuda()
    scratch = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32,
                          device="cuda")
    for _ in range(warmup):
        fn(*args)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        scratch.sum()                   # read-only L2 flush
        torch.cuda._sleep(spin)
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events)
    return BenchResult(name, ms / 1e3, bytes_moved=bytes_moved, flops=flops,
                       nnz=nnz, device_kind=torch.cuda.get_device_name())


def run_id(device=None) -> str:
    """Stamp of one bench session: the device's name and the wall date and
    minute, so records say which numbers came from the same run."""
    dev = torch.device("cuda" if device is None else device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"{kind.replace(' ', '')}-{time.strftime('%Y%m%d-%H%M')}"


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device; there is no CPU "
                           "fallback for device timing")
