"""Host cost of a B = 1 SELL product, and the pass it paces, by the way K1
is called: ``SellMatrix.spmv`` through its plan (``planned``: partial sums
and y allocated a call, the 19-argument ``tps_sell_spmm`` with the other
arguments made once as ctypes objects); the same plan with its partial
sums held by the plan (``held_part``: one allocation a call fewer, safe
only while one thread calls it); the checked one-call ``sell_spmm`` on
``x[None, :]``, then ``[0]`` (``checked``: a plan built and used once, the
path of ``autodiff``, ``parallel/sparse.py`` and ``chip_smoke.py``); and
the wrapper every call went through before plans, copied here
(``unplanned``), the same way.

Sixteen 4096 x 4096 fp32 packs at d = 0.5 (the sgemv4096 stack: too large
for L2), a pool of 64 x at half density. For each way, in shuffled turns:
host µs a product (64 products issued with no sync, over the host clock)
and passes of 16 products timed by CUDA events from before the first
dispatch to after the last, then synchronised (the benchmark's
``pass_ms``). ``--b8`` adds the same two readings at B = 8 on the route
the router picks there (ASP, K9), which plans do not reach. Run on the
card:

    PYTHONPATH=. python scripts/sell_plan_study.py --b8 --out sell_plan.json
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import time

import numpy as np
import torch

from tpusparse_torch.formats.sell import SellMatrix
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels import sell_spmv as k1
from tpusparse_torch.testing import generators
from tpusparse_torch.trace import recording, span

_PLANNED_RUN = k1.SellPlan.run
_HELD: dict[int, torch.Tensor] = {}


def _run_held(plan, x, vec=False):
    """``SellPlan.run`` with the partial sums allocated once a plan."""
    part = _HELD.get(id(plan))
    if part is None:
        part = _HELD[id(plan)] = x.new_empty(plan.pshape)
    y = x.new_empty(plan.vshape if vec else plan.yshape)
    rc = plan._fn(*plan._head, x.data_ptr(), plan._scales, part.data_ptr(),
                  y.data_ptr(), *plan._tail)
    if rc:
        _build.check(rc, "sell_spmm")
    k1.sell_spmm.launches += 1
    return y


def _unplanned(idx, vals, x, scales, n):
    """``sell_spmm`` as it was before launch plans: every check, the
    shape, two allocations, the stream object and the 19-argument call
    with its arguments converted at the call."""
    if recording():
        with span("tps.launch"):
            return _unplanned_body(idx, vals, x, scales, n)
    return _unplanned_body(idx, vals, x, scales, n)


def _unplanned_body(idx, vals, x, scales, n):
    lanes = 128
    nb, nt, w, _ = vals.shape
    if idx.shape != vals.shape or idx.dtype != torch.int8:
        raise ValueError("sell_spmm: idx vs vals")
    if vals.dtype not in k1._VALS_KIND:
        raise ValueError(f"sell_spmm: unsupported vals dtype {vals.dtype}")
    if (vals.dtype == torch.int8) != (scales is not None):
        raise ValueError("sell_spmm: int8 storage needs scales, and only it")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] > nt * lanes:
        raise ValueError("sell_spmm: x must be fp32 (B, <=m)")
    extra = () if scales is None else (scales,)
    if scales is not None and (scales.dtype != torch.float32
                               or scales.numel() != nb * lanes):
        raise ValueError("sell_spmm: scales must be fp32 (nb, 128)")
    n = nb * lanes if n is None else n
    if not 0 <= n <= nb * lanes:
        raise ValueError(f"sell_spmm: n = {n} outside 0 .. {nb * lanes}")
    dev = _build.require_cuda("sell_spmm", idx, vals, x, *extra,
                              aligned=(idx, vals))
    batch = x.shape[0]
    shape = k1.sell_shape(nb, nt, w, batch, vals.element_size(),
                          _build.sm_count(dev), _build.smem_limit(dev))
    part = torch.empty((shape.slices, batch, nb * lanes),
                       dtype=torch.float32, device=dev)
    y = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rc = _build.lib().tps_sell_spmm(
        idx.data_ptr(), vals.data_ptr(), k1._VALS_KIND[vals.dtype],
        x.data_ptr(), None if scales is None else scales.data_ptr(),
        part.data_ptr(), y.data_ptr(), nb, nt, w, batch, x.shape[1],
        shape.slices, shape.per_slice, n, shape.bb, shape.stages, dev.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "sell_spmm")
    return y


def _checked(f, x):
    return k1.sell_spmm(f.idx, f.vals, x[None, :], scales=f.scales,
                        n=f.shape[1])[0]


def _unplanned_way(f, x):
    return _unplanned(f.idx, f.vals, x[None, :], f.scales, f.shape[1])[0]


WAYS = {"planned": lambda f, x: f.spmv(x),
        "held_part": lambda f, x: f.spmv(x),
        "checked": _checked,
        "unplanned": _unplanned_way}


def _use(way):
    k1.SellPlan.run = _run_held if way == "held_part" else _PLANNED_RUN


def host_us(packs, xs, way, count=64):
    call = WAYS[way]
    _use(way)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(count):
        call(packs[i % len(packs)], xs[i % len(xs)])
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / count * 1e6


def passes_ms(packs, xs, way, count=100):
    call = WAYS[way]
    _use(way)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    out = []
    for p in range(count):
        e0.record()
        for layer, f in enumerate(packs):
            call(f, xs[(p * len(packs) + layer) % len(xs)])
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def routed_b8(dev, turns):
    """Host µs a product and the pass at B = 8 on the route
    ``auto_format(a, expect_batch=8)`` picks (ASP: K9), the products
    through ``ops.spmm``, as the benchmark's dropped stack-b8 cell made
    them."""
    from tpusparse_torch import ops
    from tpusparse_torch.formats.auto import auto_format

    packs = [auto_format(torch.from_numpy(generators.random_sparse_matrix(
        4096, 4096, density=0.5, seed=layer)).to(dev), expect_batch=8,
        device=dev) for layer in range(16)]
    xs = [torch.from_numpy(generators.random_sparse_batch(
        8, 4096, 0.5, seed=100 + j)).to(dev) for j in range(64)]
    WAYS["routed"] = lambda f, x: ops.spmm(f, x)
    passes_ms(packs, xs, "routed", count=5)
    host = [host_us(packs, xs, "routed") for _ in range(5 * turns)]
    flat = [v for _ in range(turns) for v in passes_ms(packs, xs, "routed")]
    return {"route": sorted({type(f).__name__ for f in packs}),
            "host_us_median": statistics.median(host),
            "host_us_quartiles": statistics.quantiles(host, n=4),
            "pass_ms_median": statistics.median(flat),
            "pass_ms_p95": float(np.percentile(flat, 95))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=12)
    ap.add_argument("--out", default=None)
    ap.add_argument("--b8", action="store_true",
                    help="also the router's B = 8 route (K9 on ASP)")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", torch.cuda.current_device())
    packs = [SellMatrix.from_dense(generators.random_sparse_matrix(
        4096, 4096, density=0.5, seed=layer), device=dev)
        for layer in range(16)]
    xs = [torch.from_numpy(generators.random_sparse_vector(
        4096, 0.5, seed=100 + j)).to(dev) for j in range(64)]
    want = [f.spmv(xs[0]) for f in packs]
    for way in WAYS:                    # plans built, every way checked
        _use(way)
        for f, y in zip(packs, want):
            got = WAYS[way](f, xs[0])
            torch.cuda.synchronize()
            assert torch.equal(got, y), way
        passes_ms(packs, xs, way, count=5)
    host = {w: [] for w in WAYS}
    tails = {w: [] for w in WAYS}
    rng = random.Random(0)
    for _ in range(args.turns):
        order = list(WAYS)
        rng.shuffle(order)
        for way in order:
            host[way] += [host_us(packs, xs, way) for _ in range(5)]
            tails[way].append(passes_ms(packs, xs, way))
    _use("planned")
    out = {"card": torch.cuda.get_device_name(dev),
           "torch": torch.__version__,
           "raw_stream_call": hasattr(torch._C, "_cuda_getCurrentRawStream"),
           "builds": k1.sell_plan.builds, "hits": k1.sell_plan.hits}
    for way in WAYS:
        flat = [v for t in tails[way] for v in t]
        out[way] = {
            "host_us_median": statistics.median(host[way]),
            "host_us_quartiles": statistics.quantiles(host[way], n=4),
            "pass_ms_median": statistics.median(flat),
            "pass_ms_p95": float(np.percentile(flat, 95)),
            "pass_ms_p95_turns": [float(np.percentile(t, 95))
                                  for t in tails[way]]}
    if args.b8:
        out["routed_b8"] = routed_b8(dev, args.turns)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
