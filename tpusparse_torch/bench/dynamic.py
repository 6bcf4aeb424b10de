"""Dynamic-activation serving bench: the price of the per-call x == 0 skip.

Counterpart of ``tpusparse/bench/dynamic.py``. A serving loop whose X
changes every step can be served five ways, each timed on the card:

- ``dynamic``: the device plan (``csrc/group_plan.cu``, one launch: the
  activity mask, compacted group ids and their count stay on the device),
  then K3 (AWSP) or K9 (ASP) over the live groups only. No host sync.
- ``static``: the exact host plan of one pattern, uploaded once and
  reused: the lower bound, valid only while the pattern stays fixed.
- ``full``: every group visited (no skip): what a caller pays who ignores
  the activation sparsity.
- ``replan``: the host path when patterns churn: each step copies X to the
  host (``.cpu()``, a sync), builds the exact plan in numpy, dispatches,
  and consumes y; timed in wall time per step, as in JAX.
- ``dense``: cuBLAS (``dense_torch``, true fp32) under the same changing X.

X comes from a pool of ``patterns`` activations (``_x_pool``, the JAX
package's bit for bit), each live in a different random
``round(live * ng)`` of the ng groups. JAX's ``(1 + eps)`` chain and A
replicas kept the TPU's VMEM from holding the visited slice across chained
calls; here ``device_time``'s read L2 flush before every timed call, with
the pool cycled call by call (no two timed calls in a row see the same
pattern), keeps the live-1/4 AWSP slice (~14 MB, which the 50 MB L2 would
hold) from being read out of L2.

Every pattern is first checked: ``dynamic`` and ``static`` (that
pattern's own host plan) give the same bits, and both and ``full`` are
within 1e-3 of the float64 oracle. On the CPU (``device="cpu"``) the
plain versions are checked and no time is recorded.

Run: ``python -m tpusparse_torch.bench.dynamic [--quick] [--batch B]
[--parts awsp,sweep,asp] [--json PATH] [--cpu]``.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import sys
import time
from typing import Any

import numpy as np
import torch

from tpusparse_torch.bench.roofline import checked_share, roofline_fraction
from tpusparse_torch.bench.runner import device_time, run_id
from tpusparse_torch.utils import resolve_device

_LANES = 128
ATOL = 1e-3


def _x_pool(m: int, ng: int, span: int, live: float, patterns: int,
           seed: int = 7, batch: int = 1) -> list[np.ndarray]:
    """``patterns`` dense-valued X arrays, each live in a different random
    ``max(1, round(live * ng))`` subset of the ng groups of ``span`` rows;
    ``batch > 1`` stacks rows sharing the pattern (structured activation
    sparsity is structured across the batch). (m,) at B = 1, else
    (batch, m)."""
    rng = np.random.default_rng(seed)
    k = max(1, int(round(live * ng)))
    pool = []
    for _ in range(patterns):
        groups = rng.choice(ng, size=k, replace=False)
        x = np.zeros((batch, m), dtype=np.float32)
        for gi in groups:
            lo = gi * span
            x[:, lo:min(lo + span, m)] = rng.uniform(
                -1.0, 1.0, size=(batch, min(span, m - lo)))
        pool.append(x[0] if batch == 1 else x)
    return pool


def _dense_case(m: int, n: int, d: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, size=(m, n)).astype(np.float32)
    a *= rng.uniform(size=(m, n)) < d
    return a


def _awsp_case(m: int, n: int, d: float, g: int, dev, seed: int = 11):
    from tpusparse_torch.formats.awsp import AwspMatrix

    a = _dense_case(m, n, d, seed)
    return a, AwspMatrix.from_dense(a, g=g, device=dev)


def _product(fmt, x: torch.Tensor, plan):
    return fmt.spmv(x, plan=plan) if x.ndim == 1 else fmt.spmm(x, plan=plan)


def _check(fmt, a: np.ndarray, xs: list[torch.Tensor],
           pool: list[np.ndarray]) -> float:
    """Each pattern: dynamic == static (its own host plan) bit for bit;
    dynamic and full within ``ATOL`` of the float64 oracle. Returns the
    largest error."""
    full_plan = fmt._full_plan()
    err = 0.0
    for i, (xt, x) in enumerate(zip(xs, pool)):
        want = x.astype(np.float64) @ a.astype(np.float64)
        y_dyn = _product(fmt, xt, "device")
        y_stat = _product(fmt, xt, torch.as_tensor(
            fmt.plan(x), dtype=torch.int32, device=xt.device))
        if not torch.equal(y_dyn, y_stat):
            raise AssertionError(f"{type(fmt).__name__} pattern {i}: the "
                                 f"device plan's y differs from the host "
                                 f"plan's")
        for label, y in (("dynamic", y_dyn),
                         ("full", _product(fmt, xt, full_plan))):
            e = float(np.abs(y.double().cpu().numpy() - want).max())
            if not e <= ATOL:
                raise AssertionError(f"{type(fmt).__name__} {label} pattern "
                                     f"{i}: max|err| {e:.3e} > {ATOL}")
            err = max(err, e)
    return err


def _cycled(call, fmt, xs: list[torch.Tensor]):
    """``call(fmt, x)`` with the next X of the pool at every call."""
    it = itertools.cycle(xs)
    return lambda: call(fmt, next(it))


def _timed(rows: dict, key: str, fn, nbytes: int, reps: int,
           verbose: bool) -> None:
    r = device_time(fn, name=key, bytes_moved=int(nbytes), reps=reps)
    checked_share(nbytes, r.seconds, f"{key}: {r}")
    rows[key] = (r.seconds, nbytes)
    if verbose:
        print(f"  {r}", file=sys.stderr)


def _price_host_replan(fmt, xs: list[torch.Tensor],
                       steps: int = 24) -> float:
    """Median wall seconds per step of the host-replanning loop: X lives on
    the card (a previous layer's output); each step copies it to the host
    (the sync), builds the exact plan, dispatches, and reads y's sum."""
    for x in xs:                      # warm every plan length once
        _product(fmt, x, fmt.plan(x.cpu().numpy()))
    torch.cuda.synchronize()
    times = []
    for i in range(steps):
        x = xs[i % len(xs)]
        t0 = time.perf_counter()
        plan = fmt.plan(x.cpu().numpy())          # the per-step sync
        y = _product(fmt, x, plan)
        float(y.sum())                             # the result consumed
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _record(kind: str, rows: dict, extra: dict, dev) -> dict[str, Any]:
    on_card = dev.type == "cuda"
    rec = dict(kind=kind, **extra, us=None, roofline=None,
               device=torch.cuda.get_device_name(dev) if on_card else "cpu")
    if on_card:
        rec["us"] = {k: s * 1e6 for k, (s, _) in rows.items()}
        rec["roofline"] = {k: roofline_fraction(b, s)
                           for k, (s, b) in rows.items()}
    return rec


def run_awsp(m: int = 4096, n: int = 4096, d: float = 0.5, g: int = 2,
             live: float = 0.25, patterns: int = 5, quick: bool = False,
             verbose: bool = True, batch: int = 1,
             device=None) -> dict[str, Any]:
    """AWSP serving rows at one live fraction: dynamic, static, full,
    dense, and (at B = 1) the host-replan loop."""
    from tpusparse_torch.kernels.dense import dense_torch

    dev = resolve_device(device)
    a, awsp = _awsp_case(m, n, d, g, dev)
    ng, span = awsp.n_groups, g * _LANES
    pool = _x_pool(m, ng, span, live, patterns, batch=batch)
    xs = [torch.from_numpy(x).to(dev) for x in pool]
    err = _check(awsp, a, xs, pool)
    if verbose:
        print(f"  awsp B={batch}: {patterns} patterns checked, max|err| "
              f"{err:.2e}", file=sys.stderr)
    nb, _, w, lanes = awsp.vals.shape
    full_bytes = nb * ng * g * w * lanes * 5          # every real group
    k_act = max(1, int(round(live * ng)))
    xy_bytes = batch * (m + n) * 4
    act_bytes = nb * k_act * g * w * lanes * 5 + xy_bytes
    rows: dict[str, tuple[float, int]] = {}
    replan_s = None
    if dev.type == "cuda":
        reps = 5 if quick else 20
        _timed(rows, "dynamic", _cycled(
            lambda f, x: _product(f, x, "device"), awsp, xs), act_bytes,
            reps, verbose)
        static_plan = torch.as_tensor(awsp.plan(pool[0]), dtype=torch.int32,
                                      device=dev)
        _timed(rows, "static", _cycled(
            lambda f, x: _product(f, x, static_plan), awsp, xs[:1]),
            act_bytes, reps, verbose)
        full_plan = awsp._full_plan()
        _timed(rows, "full", _cycled(
            lambda f, x: _product(f, x, full_plan), awsp, xs), full_bytes,
            reps, verbose)
        _timed(rows, "dense", _cycled(dense_torch, torch.from_numpy(a).to(
            dev), xs), m * n * 4, reps, verbose)
        if batch == 1:
            replan_s = _price_host_replan(awsp, xs, steps=4 if quick else 24)
            if verbose:
                print(f"  host-replan serving loop: {replan_s * 1e3:.3f} "
                      f"ms/step", file=sys.stderr)
    return _record("awsp", rows, dict(
        m=m, n=n, d=d, g=g, ng=ng, live=live, batch=batch,
        patterns=patterns, act_bytes=act_bytes, full_bytes=full_bytes,
        replan_ms=None if replan_s is None else replan_s * 1e3, err=err),
        dev)


def run_awsp_sweep(m: int = 4096, n: int = 4096, d: float = 0.5,
                   g: int = 2, lives=(0.0625, 0.25, 0.5, 1.0),
                   quick: bool = False, verbose: bool = True,
                   device=None) -> list[dict[str, Any]]:
    """The dynamic path alone across live fractions (B = 1): time should
    follow the live bytes, and live = 1 prices the device plan against
    the full plan."""
    dev = resolve_device(device)
    a, awsp = _awsp_case(m, n, d, g, dev)
    ng, span = awsp.n_groups, g * _LANES
    nb, _, w, lanes = awsp.vals.shape
    out = []
    for live in lives:
        pool = _x_pool(m, ng, span, live, patterns=5)
        xs = [torch.from_numpy(x).to(dev) for x in pool]
        err = _check(awsp, a, xs, pool)
        k_act = max(1, int(round(live * ng)))
        act_bytes = nb * k_act * g * w * lanes * 5
        rec = dict(live=live, act_bytes=act_bytes, err=err, us=None,
                   roofline=None)
        if dev.type == "cuda":
            rows: dict[str, tuple[float, int]] = {}
            _timed(rows, f"awsp dynamic live={live}", _cycled(
                lambda f, x: _product(f, x, "device"), awsp, xs), act_bytes,
                5 if quick else 20, verbose)
            (s, _), = rows.values()
            rec.update(us=s * 1e6, roofline=roofline_fraction(act_bytes, s))
        out.append(rec)
    return out


def run_asp(m: int = 4096, n: int = 4096, d: float = 0.5,
            live: float = 0.25, patterns: int = 5, quick: bool = False,
            verbose: bool = True, batch: int = 1,
            device=None) -> dict[str, Any]:
    """ASP (dense A, 128-row window skip): dynamic, static, full, and at
    B > 1 dense under the same churn."""
    from tpusparse_torch.kernels.asp_spmv import AspMatrix
    from tpusparse_torch.kernels.dense import dense_torch

    dev = resolve_device(device)
    a = _dense_case(m, n, d, 13)
    asp = AspMatrix.from_dense(a, device=dev)
    nt = m // _LANES
    pool = _x_pool(m, nt, _LANES, live, patterns, batch=batch)
    xs = [torch.from_numpy(x).to(dev) for x in pool]
    err = _check(asp, a, xs, pool)
    if verbose:
        print(f"  asp B={batch}: {patterns} patterns checked, max|err| "
              f"{err:.2e}", file=sys.stderr)
    k_act = max(1, int(round(live * nt)))
    act_bytes = k_act * _LANES * asp.a_pad.shape[1] * 4
    full_bytes = m * n * 4
    if batch > 1:
        # X and Y scale with B while A does not
        act_bytes += batch * (m + n) * 4
        full_bytes += batch * (m + n) * 4
    rows: dict[str, tuple[float, int]] = {}
    if dev.type == "cuda":
        reps = 5 if quick else 20
        _timed(rows, "dynamic", _cycled(
            lambda f, x: _product(f, x, "device"), asp, xs), act_bytes,
            reps, verbose)
        static_plan = torch.as_tensor(asp.plan(pool[0]), dtype=torch.int32,
                                      device=dev)
        _timed(rows, "static", _cycled(
            lambda f, x: _product(f, x, static_plan), asp, xs[:1]),
            act_bytes, reps, verbose)
        full_plan = asp._full_plan()
        _timed(rows, "full", _cycled(
            lambda f, x: _product(f, x, full_plan), asp, xs), full_bytes,
            reps, verbose)
        if batch > 1:
            _timed(rows, "dense", _cycled(dense_torch, torch.from_numpy(
                a).to(dev), xs), full_bytes, reps, verbose)
    return _record("asp", rows, dict(
        m=m, n=n, d=d, live=live, batch=batch, patterns=patterns,
        act_bytes=act_bytes, full_bytes=full_bytes, err=err), dev)


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="tpusparse_torch dynamic",
                                description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="5 timed calls a variant, 4 replan steps")
    p.add_argument("--json", default=None,
                   help="merge the result into this file (none by default)")
    p.add_argument("--parts", default="awsp,sweep,asp")
    p.add_argument("--batch", type=int, default=1,
                   help="awsp and asp batch (recorded as awsp_b{B}, "
                        "asp_b{B})")
    p.add_argument("--cpu", action="store_true",
                   help="check on the CPU (plain versions, no times)")
    args = p.parse_args(argv)
    dev = "cpu" if args.cpu else None
    out: dict[str, Any] = dict(run=run_id(dev))
    parts = args.parts.split(",")
    suffix = "" if args.batch == 1 else f"_b{args.batch}"
    if "awsp" in parts:
        out["awsp" + suffix] = run_awsp(quick=args.quick, batch=args.batch,
                                        device=dev)
    if "sweep" in parts:
        out["sweep"] = run_awsp_sweep(quick=args.quick, device=dev)
    if "asp" in parts:
        out["asp" + suffix] = run_asp(quick=args.quick, batch=args.batch,
                                      device=dev)
    if args.json:
        old = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                old = json.load(f)
        old.update(out)
        with open(args.json, "w") as f:
            json.dump(old, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
