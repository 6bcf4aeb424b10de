"""Spans for the profiler, free until something records them.

``span(name)`` returns a shared null context unless a profiler is
recording: ``torch.profiler`` (the benchmark's traced runs, the CLI's
``profile``) or ``torch.autograd.profiler.emit_nvtx()`` under Nsight
Systems. Then it opens a ``record_function`` range of that name, which
lands among the profiler's host events, on the clock the device activity
shares. ``spanned(name)`` is the same as a decorator; ``recording()`` is
the check alone, for a hot function that gates its body inline: in a
B = 1 SELL product on the H100 machine's host, the decorator's frame adds
~0.5 µs a call to the check's ~0.6 µs.

The spans, each fixed by name:

- ``tps.spmv`` / ``tps.spmm``: a compute format's public ``spmv`` /
  ``spmm``: the format layer (input placement, reshapes, the kernel's
  choice) and the kernel calls under it;
- ``tps.launch``: a kernel wrapper in ``kernels/`` that calls the CUDA
  library: its checks, launch shape, output allocation and the ctypes
  call (its plain version, on the CPU); for K1, whose checks and launch
  shape a plan fixes beforehand (``kernels/sell_spmv.py`` ``SellPlan``),
  the ctypes call alone;
- ``tps.stop``: a solver's host read of its stopping test
  (``solve.stop_test``): the host blocked until the device catches up;
- ``tps.moe``, ``tps.moe.route``, ``tps.moe.experts``,
  ``tps.moe.shared``: a ``moe.SparseMoE`` forward and its router, routed
  experts and shared experts (``moe.py`` lists them with its counters).
"""

from __future__ import annotations

import contextlib
import functools

import torch

recording = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
# the lighter range where this torch has it
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def span(name: str):
    """A context for ``with``: the range ``name`` while a profiler records,
    else a shared null context."""
    return _Range(name) if recording() else _NULL


def spanned(name: str):
    """Decorator: each call of the function runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with _Range(name):
                return fn(*args, **kwargs)
        return call
    return wrap
