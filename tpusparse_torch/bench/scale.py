"""GB-scale unstructured run: one large powerlaw matrix from generation to a
training step, on the card.

Counterpart of ``tpusparse/bench/scale.py``. At its default, 262144^2 at
d = 2e-3 (the JAX package's headline config), in order:

- host generation wall time (``random_sparse_csr``, never densified);
- the O(nnz) statistics and the router's pick (``matrix_stats_csr``,
  ``route``);
- the "cliff" gate: the pick's predicted bytes (``predicted_bytes``)
  against the card's budget, ``torch.cuda.mem_get_info()``'s free bytes
  less ``HEADROOM`` (the JAX package used the TPU's 12 GB); past it the
  record states the quantum-floor law instead of packing;
- the converter's wall time (``auto_format`` on the host);
- one upload, timed to a synchronise (``formats.io.to_device``);
- y against the float64 oracle (scipy on the CSR, within 1e-3), then the
  SpMV's device time (``device_time``: CUDA events after the read L2
  flush) and its share of the bytes bound;
- a Krylov iteration's device time: one SpMV and one axpy;
- a ``trainable_linear`` fwd+bwd step (K1 forward, K10 for both value
  gradients), after its own gate: the live operands of the step (params,
  their grads, the structure planes and the uploaded pack: the JAX
  package's count) against the same budget. The twin layouts' sizes are
  counted from the CSR (``twin_slots``) before they are packed, so a
  gated step never builds them on the host (the JAX package packed first).
  The step's y is held to the oracle, and ``GRAD_SAMPLE`` seeded slots of
  each value gradient to float64 ``x[i] * 2 y[j]``, within 1e-3.

Every record names the budget it used (``budget_gb``, ``budget_from``).
``--m`` small runs on the CPU (``--cpu``): the checks run, no time is
recorded, and the budget is the caller's (``run(budget=)``; none by
default).

The default config is itself a finding of the JAX package: the matrix
touches ~99% of its 128^2 tiles at a per-tile fill under one slot row, so
every slot format floors at the chunk quantum (15.5 GB predicted for
RSELL after its column sort). Whether that fits the card's 80 GB, and
what the 65536^2 d = 0.02 point (inside the quantum-competence region)
costs, is what this run measures.

Run: ``python -m tpusparse_torch.bench.scale [--m 262144]
[--density 2e-3] [--no-train] [--json PATH] [--cpu]``.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Any

import numpy as np
import torch

from tpusparse_torch.utils import resolve_device

HEADROOM = 4_000_000_000   # X, Y, the L2 flush buffer, cuBLAS workspace,
                           # the allocator's slack
ATOL = 1e-3
GRAD_SAMPLE = 4096         # value-gradient slots checked in each layout


def _wall(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


def _budget(dev: torch.device, budget: int | None) -> tuple[int | None, str]:
    if budget is not None:
        return int(budget), "caller"
    if dev.type != "cuda":
        return None, "none"
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    return free - HEADROOM, f"mem_get_info free {free / 1e9:.2f} GB " \
        f"less {HEADROOM / 1e9:.0f} GB headroom"


def twin_slots(csr) -> tuple[int, int]:
    """The slots of ``trainable_linear``'s two flat SELL layouts (A's and
    A.T's), from O(nnz) counts, before anything is packed: each is every
    128 x 128 tile at the largest window-column count, rounded up to 8."""
    from tpusparse_torch.formats.csr import col_window_widths
    from tpusparse_torch.utils import cdiv, round_up

    out = []
    for c in (csr, csr.transpose()):
        m, n = c.shape
        w = round_up(max(int(col_window_widths(c).max(initial=0)), 8), 8)
        out.append(cdiv(n, 128) * cdiv(m, 128) * w * 128)
    return tuple(out)


def _grad_sample(c, flat: np.ndarray, rng, x: np.ndarray, y: np.ndarray,
                 transposed: bool) -> tuple[np.ndarray, np.ndarray]:
    """``GRAD_SAMPLE`` entries of ``c`` (A's ``CsrMatrix``, or A.T's when
    ``transposed``): their flat slots in the layout packed from ``c``, and
    the float64 value gradient of ``sum(y^2)`` there, ``x[i] * 2 y[j]``
    for A's entry (i, j). A ``CsrMatrix`` row is an output column."""
    k = rng.choice(c.nnz, size=min(GRAD_SAMPLE, c.nnz), replace=False)
    r = np.searchsorted(c.row_ptr, k, side="right") - 1
    col = c.col_idx[k]
    i, j = (r, col) if transposed else (col, r)
    return flat[k], x[i].astype(np.float64) * 2 * y[j]


def run(m: int = 262144, density: float = 2e-3, seed: int = 42,
        train: bool = True, device=None, budget: int | None = None,
        verbose: bool = True) -> dict[str, Any]:
    """One record. ``budget``: device bytes the gates allow (None: the
    card's free memory less ``HEADROOM``; no gate on the CPU)."""
    from tpusparse_torch.autodiff import TwinSell, _TwinPack, twin_params
    from tpusparse_torch.bench.roofline import checked_share, format_bytes
    from tpusparse_torch.bench.runner import device_time, run_id
    from tpusparse_torch.formats.auto import (auto_format, matrix_stats_csr,
                                              predicted_bytes, route)
    from tpusparse_torch.formats.io import to_device
    from tpusparse_torch.testing import generators
    from tpusparse_torch.testing.reference import csr_spmm_cpu

    def log(msg):
        if verbose:
            print(msg, file=sys.stderr, flush=True)

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    budget, budget_from = _budget(dev, budget)
    rec: dict[str, Any] = dict(
        run=run_id(dev), m=m, n=m, density=density,
        device=torch.cuda.get_device_name(dev) if on_card else "cpu",
        budget_gb=None if budget is None else budget / 1e9,
        budget_from=budget_from)

    csr, rec["gen_s"] = _wall(generators.random_sparse_csr, m, m, density,
                              seed=seed, distribution="powerlaw")
    rec["nnz"] = int(csr.nnz)
    log(f"generated {csr.nnz:,} nnz in {rec['gen_s']:.1f} s")
    stats, rec["stats_s"] = _wall(matrix_stats_csr, csr)
    routed = route(m, m, stats)
    rec["routed"] = routed
    pred = predicted_bytes(m, m, stats, routed, csr=csr)
    rec["predicted_gb"] = pred / 1e9
    log(f"stats in {rec['stats_s']:.1f} s -> {routed}, {pred / 1e9:.2f} GB "
        f"predicted")
    if budget is not None and pred > budget:
        ntile = ((m + 127) // 128) ** 2
        rec["cliff"] = "quantum_floor"
        rec["touched_tile_frac"] = 1 - stats["empty_block_frac"]
        rec["floor_law"] = (
            f"slot formats >= round_up(w_tile,8) x 640 B per touched 128^2 "
            f"tile; {rec['touched_tile_frac']:.1%} of {ntile:,} tiles "
            f"touched -> {pred / 1e9:.1f} GB predicted for '{routed}' > "
            f"{budget / 1e9:.1f} GB budget ({budget_from}); this regime "
            f"needs the multi-rank partitions")
        log(f"CLIFF: {rec['floor_law']}")
        return rec

    host, rec["pack_s"] = _wall(auto_format, csr, stats=stats, device="cpu")
    nbytes = format_bytes(host)
    rec["format"] = type(host).__name__
    rec["format_gb"] = nbytes / 1e9
    log(f"packed {rec['format']}: {nbytes / 1e9:.3f} GB in "
        f"{rec['pack_s']:.1f} s")
    t0 = time.perf_counter()
    fmt = to_device(host, dev)
    if on_card:
        torch.cuda.synchronize(dev)
    rec["upload_s"] = time.perf_counter() - t0
    del host
    log(f"uploaded once in {rec['upload_s']:.2f} s")

    x = np.random.default_rng(seed).uniform(-1, 1, m).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    y_ref = csr_spmm_cpu(x, csr)
    y = fmt.spmv(xt)
    rec["max_abs_err"] = float(np.abs(y.double().cpu().numpy() - y_ref).max())
    if not rec["max_abs_err"] <= ATOL:
        raise AssertionError(f"scale {m}^2: max|err| {rec['max_abs_err']:.3e}"
                             f" > {ATOL} against the oracle")
    if on_card:
        step_bytes = nbytes + 8 * m                 # + x read, y written
        r = device_time(lambda: fmt.spmv(xt), name=f"scale-spmv[{rec[
            'format']}]", bytes_moved=step_bytes, nnz=csr.nnz)
        rec["spmv_us"] = r.seconds * 1e6
        rec["spmv_roofline"] = checked_share(step_bytes, r.seconds,
                                             f"scale {m}^2")
        rec["spmv_gnnz_s"] = csr.nnz / r.seconds / 1e9
        log(f"  {r} | share {rec['spmv_roofline']:.3f}")
        # a Krylov iteration's traffic: the SpMV and one axpy
        ri = device_time(lambda: torch.add(xt, fmt.spmv(xt), alpha=1e-6),
                         name="scale-iter")
        rec["iter_us"] = ri.seconds * 1e6
        log(f"  per iteration (spmv + axpy): {ri}")
    if not train:
        return rec

    slots = twin_slots(csr)
    twin_b, statics_b = 4 * sum(slots), 2 * sum(slots)
    need = 2 * twin_b + statics_b + nbytes
    rec["train_operands_gb"] = need / 1e9
    log(f"a train step holds {need / 1e9:.1f} GB live")
    if budget is not None and need > budget:
        rec["train_gate"] = (
            f"params {twin_b / 1e9:.1f} + grads {twin_b / 1e9:.1f} + "
            f"structure planes {statics_b / 1e9:.1f} + uploaded pack "
            f"{nbytes / 1e9:.1f} = {need / 1e9:.1f} GB live > "
            f"{budget / 1e9:.1f} GB budget ({budget_from}); use "
            f"trainable_linear_sharded on a mesh")
        log(f"  train step gated: {rec['train_gate']}")
        return rec
    pack, rec["twin_pack_s"] = _wall(_TwinPack, csr)
    got = (pack.fmt["vals"].numel(), pack.fmt_t["vals"].numel())
    if got != slots:
        raise AssertionError(f"twin pack of {got} slots, {slots} predicted")
    log(f"twin pack in {rec['twin_pack_s']:.1f} s")
    # d(sum y^2)/dA[i, j] = x[i] * 2 y[j], sampled in both layouts
    rng = np.random.default_rng(seed)
    samples = [_grad_sample(c, flat, rng, x, y_ref, t)
               for c, flat, t in ((pack.csr, pack.flat_f, False),
                                  (pack.csr_t, pack.flat_t, True))]
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    statics, params = twin_params(pack, dev)
    shape = pack.fmt["shape"]
    del pack
    if on_card:
        torch.cuda.synchronize(dev)
    rec["twin_upload_s"] = time.perf_counter() - t0
    targets = [params["vals"].requires_grad_(),
               params["vals_t"].requires_grad_()]

    def step():
        y = TwinSell.apply(params["vals"], params["vals_t"], xt, statics,
                           shape)
        return torch.autograd.grad((y ** 2).sum(), targets)

    # the step's y (K1) against the oracle, then its value gradients (K10)
    # at the sampled slots
    y_step = TwinSell.apply(params["vals"].detach(), params["vals_t"]
                            .detach(), xt, statics, shape)
    rec["train_y_err"] = float(np.abs(y_step.double().cpu().numpy()
                                      - y_ref).max())
    del y_step
    grads = step()
    rec["train_grad_err"] = max(
        float(np.abs(g.reshape(-1)[torch.from_numpy(slot).to(dev)].double()
                     .cpu().numpy() - want).max())
        for g, (slot, want) in zip(grads, samples))
    del grads
    for key in ("train_y_err", "train_grad_err"):
        if not rec[key] <= ATOL:
            raise AssertionError(f"scale {m}^2: {key} {rec[key]:.3e} > "
                                 f"{ATOL} against the oracle")
    if on_card:
        rt = device_time(step, name="scale-train-step")
        rec["train_us"] = rt.seconds * 1e6
        rec["train_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"  fwd+bwd step: {rt}")
    return rec


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="tpusparse_torch scale",
                                description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=262144)
    p.add_argument("--density", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--json", default=None,
                   help="append the record to this file (none by default)")
    p.add_argument("--cpu", action="store_true",
                   help="check on the CPU (plain versions, no times)")
    args = p.parse_args(argv)
    rec = run(m=args.m, density=args.density, seed=args.seed,
              train=not args.no_train, device="cpu" if args.cpu else None)
    if args.json:
        import os

        recs = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                recs = json.load(f)
        recs = [r for r in recs if (r.get("m"), r.get("density"))
                != (rec["m"], rec["density"])]
        recs.append(rec)
        with open(args.json, "w") as f:
            json.dump(recs, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
