"""Reduce a ``torch.profiler`` trace of a run's traced slice to the record
that the per-layer metrics read.

The spans are the benchmark's own ``record_function`` ranges around the
calls it makes into the program. A device operation belongs to a span when
the host call that launched it (linked by the profiler's correlation id)
started inside that span. Nothing is written to disk: the profiler's
events are read in memory.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

TOP = 10                   # entries in each list of the breakdown
_WALK = 4096               # host events looked at behind an idle gap


class Event:
    """One profiler event, in seconds of the trace's clock."""

    __slots__ = ("name", "start", "end", "corr", "link", "tid")

    def __init__(self, name, start, end, corr=0, tid=0, link=0):
        self.name, self.start, self.end = name, start, end
        self.corr, self.tid, self.link = corr, tid, link


def profile(fn, spans=()):
    """Run ``fn`` under the profiler (host and CUDA activity); returns
    ``(fn's result, host events, device events)``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    host, dev = split_events(prof.profiler.kineto_results.events(), spans)
    return out, host, dev


def split_events(events, spans=()) -> tuple[list[Event], list[Event]]:
    """Host events (with their correlation id) and device operations (with
    their own correlation id, which their launch's CUDA runtime call shares,
    and the one of the torch operation they are linked to). The device
    side's own copies of the spans (user annotations, named as the spans)
    are left out."""
    cpu = torch.autograd.DeviceType.CPU
    host, dev = [], []
    for e in events:
        ev = Event(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == cpu:
            ev.corr, ev.tid = e.correlation_id(), e.start_thread_id()
            host.append(ev)
        elif not e.is_user_annotation() and e.name() not in spans:
            ev.corr, ev.link = e.correlation_id(), e.linked_correlation_id()
            dev.append(ev)
    return host, dev


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(host: list[Event], dev: list[Event],
           span_names: tuple[str, ...]) -> dict:
    """``window_s`` (first span's start to last span's end), ``busy_s``
    (the union of device operations inside it), ``spans`` (for each name:
    ``count``, host seconds ``cpu_s``, and ``device_s``, the device time of
    the operations launched inside), ``attributed_s`` (device time under
    any span) and the ``breakdown``."""
    spans = {n: sorted((e for e in host if e.name == n),
                       key=lambda e: e.start) for n in span_names}
    every = [e for n in span_names for e in spans[n]]
    if not every:
        raise ValueError(f"the trace holds none of the spans {span_names}")
    w0 = min(e.start for e in every)
    w1 = max(e.end for e in every)
    tid = every[0].tid
    # a device operation's launch: the CUDA runtime call that shares its
    # correlation id (named cuda*/cu*), else the torch operation it links to
    runtime = {e.corr: e.start for e in host
               if e.corr and e.name.startswith("cu")}
    ops = {e.corr: e.start for e in host
           if e.corr and not e.name.startswith("cu")}
    starts = {n: [e.start for e in spans[n]] for n in span_names}
    dev_s = dict.fromkeys(span_names, 0.0)
    attributed = 0.0
    by_name: dict[str, float] = defaultdict(float)
    inside = []
    for d in dev:
        if d.end <= w0 or d.start >= w1:
            continue
        dur = d.end - d.start
        by_name[d.name[:80]] += dur
        inside.append((max(d.start, w0), min(d.end, w1)))
        t = runtime.get(d.corr, ops.get(d.link))
        if t is None:
            continue
        hit = False
        for n in span_names:
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and spans[n][i].end >= t:
                dev_s[n] += dur
                hit = True
        attributed += dur if hit else 0.0
    busy = _merge(inside)
    busy_s = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return {
        "window_s": w1 - w0,
        "busy_s": busy_s,
        "attributed_s": attributed,
        "spans": {n: {"count": len(spans[n]),
                      "cpu_s": sum(e.end - e.start for e in spans[n]),
                      "device_s": dev_s[n]} for n in span_names},
        "breakdown": {
            "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": _idle_by_host(gaps, [e for e in host
                                              if e.tid == tid]),
        },
    }


def _idle_by_host(gaps, host: list[Event]) -> list:
    """The device's idle gaps summed by what the host was doing at each
    gap's middle: the innermost host event covering it."""
    host = sorted(host, key=lambda e: e.start)
    starts = [e.start for e in host]
    out: dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host"
        for j in range(i, max(i - _WALK, -1), -1):
            if host[j].end >= mid:
                name = host[j].name
                break
        out[name[:80]] += e - s
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda kv: -kv[1])[:TOP]
