"""The harness: one run of one cell, driven by ``BENCHMARK.json``.

A run loads the cell's configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``) and its driver (``configs/<config>.py``), sets
up, and then either measures the cell's end-to-end metrics over a closed
loop of ``--seconds`` (``--trace 0``) or profiles a fixed slice of the same
loop and reads the per-layer metrics from it (``--trace 1``), each metric by
its own reader (``metrics/<metric>.py``). Once the window has closed, the
peak memory has been read and the program's state is freed, the driver's
plain reference judges a sample of the answers. The last line on standard
output is the result as one JSON object.

A driver module defines ``Run(cfg, traffic, seed, device, system=None)``
with ``spans`` (the top-level span first), ``phases`` (set-up seconds by
phase), ``traced`` (set: put the inner
spans around the program's calls), ``step(i)`` (one request of the
closed loop), ``reset()``, ``counters()``, ``end_to_end(loop)``,
``attempted``, ``route``, ``release()`` and ``check()``. ``system`` replaces
the program (the reference's lower-precision control, or a broken program
in the tests).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import random
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusparse")


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under this folder, imported once by path."""
    mod_name = f"bm_{kind}_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(
        mod_name, HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Sampler:
    """A reservoir of ``k`` step indices drawn from the seed: ``offer(i)``
    gives the slot that step ``i`` takes, or None."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)

    def offer(self, i: int):
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def closed_loop(step, device, *, seconds: float | None = None,
                count: int | None = None, span: str | None = None) -> dict:
    """Run ``step(i)`` back to back, for ``seconds`` or ``count`` steps.
    Each step is timed from before its first dispatch to the end of its
    last device operation by CUDA events on the stream (on the CPU, by the
    host clock); the loop's ``elapsed_s`` is the host clock over all of
    it."""
    import torch
    from torch.profiler import record_function

    cuda = device.type == "cuda"
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
    step_ms = []
    n = 0
    t0 = time.perf_counter()
    while True:
        with record_function(span) if span else contextlib.nullcontext():
            if cuda:
                e0.record()
                step(n)
                e1.record()
                e1.synchronize()
            else:
                h = time.perf_counter()
                step(n)
        step_ms.append(e0.elapsed_time(e1) if cuda
                       else (time.perf_counter() - h) * 1e3)
        n += 1
        if (n >= count) if count is not None else \
                (time.perf_counter() - t0 >= seconds):
            break
    return {"n": n, "elapsed_s": time.perf_counter() - t0,
            "step_ms": step_ms}


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, *, system=None, cfg_over=None,
             traffic_over=None, t0: float | None = None) -> dict:
    """One run of one cell on ``device``; returns the result line as a
    dict (``checks`` last). ``system``, ``cfg_over`` and ``traffic_over``
    are for the control and the tests."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    t_entry = time.perf_counter()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = {**load_json("configs", cell["config"]), **(cfg_over or {})}
    traffic = {**load_json("traffic", cell["traffic"]),
               **(traffic_over or {})}
    driver = load_module("configs", cell["config"])
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = driver.Run(cfg, traffic, seed, device, system)
    if cuda:
        torch.cuda.synchronize(device)
    # what set-up made lives to the end: out of the collector's way, so
    # that a full collection in the window walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    print(json.dumps({"route": run.route}), flush=True)
    print(json.dumps({"setup_s": {"start_to_harness": t_entry - t0,
                                  **run.phases, "total": setup_s}}),
          flush=True)
    run.traced = trace
    run.reset()
    out: dict = {}
    if trace:
        from benchmarks import peaks, tracing

        _, host, dev = tracing.profile(lambda: closed_loop(
            run.step, device, count=traffic["trace_steps"],
            span=run.spans[0]), run.spans)
        rec = tracing.reduce(host, dev, run.spans)
        print(json.dumps({"trace": {k: rec[k] for k in (
            "window_s", "busy_s", "attributed_s", "spans")},
            "device_events": len(dev)}), flush=True)
        rec["counters"] = run.counters()
        rec["peaks"] = peaks.peaks_of(kind) if cuda else None
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, cell_name):
                continue
            v = load_module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = rec["breakdown"]
        traced = {"busy_s": rec["busy_s"], "window_s": rec["window_s"]}
    else:
        loop = closed_loop(run.step, device, seconds=seconds)
        e2e = {**run.end_to_end(loop), "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, cell_name)}
        traced = {}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted = run.attempted
    run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = run.check()
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                       "count": cell["chips"], "memory_peak_bytes": peak,
                       **traced}}
    line.update(out)
    # JSON has no infinity: a reading that is not finite prints as 1e308
    line["checks"] = {k: {"value": v if math.isfinite(v) else 1e308,
                          "limit": lim} for k, (v, lim) in checks.items()}
    return line


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}: nothing is timed",
              file=sys.stderr)
        return 3
    from benchmarks import peaks

    # to standard error: a run that stops before its result prints nothing
    # on standard output
    print(json.dumps({"card": peaks.card_info(),
                      "torch": torch.__version__}), file=sys.stderr)
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0), t0=t0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: JAX or the JAX package",
              file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
