"""Command line of the port: correctness runs, benchmarks, the solver.

Counterpart of ``tpusparse/cli.py``, with its subcommands and arguments
but ``tune`` (the TPU's Pallas step geometry has no meaning on Hopper):

    python -m tpusparse_torch check --m 4096 --n 4096 --density 0.5
    python -m tpusparse_torch bench --kernels dense_torch,sell_cuda
    python -m tpusparse_torch headline
    python -m tpusparse_torch profile
    python -m tpusparse_torch report --sections canonical,spmm
    python -m tpusparse_torch mtx data/fem_mesh_16384.mtx
    python -m tpusparse_torch solve --file data/fem_mesh_16384.mtx --precond amg
    python -m tpusparse_torch scaling --model
    python -m tpusparse_torch gallery --batch 8
    python -m tpusparse_torch dynamic --quick
    python -m tpusparse_torch scale --m 65536 --density 0.02

Every command runs on the card; ``--cpu`` runs the kernels' plain PyTorch
versions on the CPU (``device="cpu"``), which checks results and times
nothing: ``bench``, ``headline``, ``profile`` and ``report`` exist to time
and refuse ``--cpu``. ``check`` and ``bench`` take the full registry
(``bench.suite.registry(full=True)``), as the JAX commands do. ``profile``
prints each CUDA kernel's device time on ``bench/profile.py``'s fixed
paths (JAX's XProf trace and its workload arguments have no counterpart).
``gallery``, ``dynamic`` and ``scale`` pass their arguments to the
bench's own ``main``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_workload_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--m", type=int, default=4096)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--density", type=float, default=0.5)
    p.add_argument("--x-density", type=float, default=0.5)
    p.add_argument("--distribution", default="uniform",
                   choices=["uniform", "powerlaw", "banded", "blocks"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kernels", default="all",
                   help="comma-separated registry names, or 'all'")
    p.add_argument("--cpu", action="store_true",
                   help="the plain PyTorch versions on the CPU")


def _config_from(args):
    from tpusparse_torch.config import SpmvConfig

    return SpmvConfig(m=args.m, n=args.n, batch=args.batch,
                      density=args.density, x_density=args.x_density,
                      distribution=args.distribution, seed=args.seed)


def _device(args):
    return "cpu" if getattr(args, "cpu", False) else None


def _select(entries, names: str):
    if names == "all":
        return entries
    wanted = [s.strip() for s in names.split(",")]
    by_name = {e["name"]: e for e in entries}
    missing = [w for w in wanted if w not in by_name]
    if missing:
        raise SystemExit(f"unknown kernels: {missing}; available: "
                         f"{sorted(by_name)}")
    return [by_name[w] for w in wanted]


def _timing_only(args, name: str) -> bool:
    if getattr(args, "cpu", False):
        print(f"{name} times kernels on the card; on the CPU there is "
              f"nothing to time (use `check --cpu`)", file=sys.stderr)
        return True
    return False


def cmd_check(args) -> int:
    from tpusparse_torch.bench.suite import registry
    from tpusparse_torch.testing.tester import KernelEntry, SpmvTester

    tester = SpmvTester(_config_from(args), device=_device(args))
    for e in _select(registry(full=True), args.kernels):
        tester.register(KernelEntry(e["name"], e["prepare"], e["run"]))
    reports = tester.run(raise_on_fail=False)
    return 0 if all(r.ok for r in reports) else 1


def cmd_bench(args) -> int:
    """The registry's kernels timed on the workload; ``--format json|csv``
    gives one record per kernel."""
    if _timing_only(args, "bench"):
        return 2
    from tpusparse_torch.bench.roofline import roofline_fraction
    from tpusparse_torch.bench.suite import registry, sweep

    cfg = _config_from(args)
    results = sweep(cfg, verbose=args.format == "text",
                    entries=_select(registry(full=True), args.kernels))
    if args.format == "text":
        return 0
    records = [
        dict(kernel=r.name, m=cfg.m, n=cfg.n, batch=cfg.batch,
             density=cfg.density, x_density=cfg.x_density,
             distribution=cfg.distribution, seed=cfg.seed,
             us=r.seconds * 1e6, gbps=r.gbps, gflops=r.gflops,
             gnnz_per_s=r.nnz_per_s / 1e9 if r.nnz_per_s else None,
             roofline_frac=roofline_fraction(r.bytes_moved, r.seconds)
             if r.bytes_moved else None,
             bytes_moved=r.bytes_moved, device=r.device_kind)
        for r in results]
    if args.format == "json":
        for rec in records:
            print(json.dumps(rec))
    elif records:
        import csv

        w = csv.DictWriter(sys.stdout, fieldnames=list(records[0]))
        w.writeheader()
        w.writerows(records)
    return 0


def cmd_headline(args) -> int:
    if _timing_only(args, "headline"):
        return 2
    from tpusparse_torch.bench.suite import headline

    print(json.dumps(headline()))
    return 0


def cmd_profile(args) -> int:
    """Each CUDA kernel's device time per call on ``bench/profile.py``'s
    paths, one JSON line per entry."""
    if _timing_only(args, "profile"):
        return 2
    from tpusparse_torch.bench.profile import main as profile_main

    profile_main()
    return 0


def cmd_report(args) -> int:
    """The measured report (Markdown on stdout); ``--sections`` splits a
    long run."""
    if _timing_only(args, "report"):
        return 2
    from tpusparse_torch.bench.report import main as report_main

    report_main(sections=set(args.sections.split(","))
                if args.sections else None)
    return 0


def _load_csr(path: str):
    import numpy as np

    from tpusparse_torch.formats.csr import CsrMatrix

    csr = CsrMatrix.from_mtx(path)
    if csr.values.dtype != np.float32:
        csr.values = csr.values.astype(np.float32)
    return csr


def cmd_mtx(args) -> int:
    """Route, check and time a MatrixMarket matrix, never densified: CSR
    ingestion, O(nnz) statistics, ``auto_format``, y against the float64
    oracle on the CSR, then the device time of the routed product."""
    import numpy as np
    import torch

    from tpusparse_torch.bench.roofline import (format_bytes,
                                                roofline_fraction)
    from tpusparse_torch.bench.runner import device_time
    from tpusparse_torch.formats.auto import (auto_format, matrix_stats_csr,
                                              route)
    from tpusparse_torch.formats.awsp import PlanSkip
    from tpusparse_torch.testing import generators
    from tpusparse_torch.testing.reference import csr_spmm_cpu
    from tpusparse_torch.utils import resolve_device

    dev = resolve_device(_device(args))
    csr = _load_csr(args.file)
    m, n = csr.shape
    s = matrix_stats_csr(csr)
    print(f"{args.file}: {m}x{n}, nnz={s['nnz']} (d={s['density']:.4f}), "
          f"empty 128x128 tiles {s['empty_block_frac'] * 100:.0f}%, "
          f"width demand max/typical {s['w_global']}/{s['w_typical']:.0f}")
    print(f"route: {route(m, n, s, expect_batch=args.batch)}")
    fmt = auto_format(csr, stats=s, expect_batch=args.batch, device=dev)
    print(f"routed to {fmt!r}")
    x = generators.random_sparse_vector(m, density=args.x_density,
                                        seed=args.seed)
    y = fmt.spmv(torch.from_numpy(x).to(dev))
    err = float(np.abs(y.double().cpu().numpy() - csr_spmm_cpu(x, csr)).max()) \
        if n else 0.0
    ok = err <= 1e-3
    print(f"max|err| vs float64 oracle: {err:.3e} "
          f"({'OK' if ok else 'FAIL'})")
    if args.no_time or dev.type != "cuda":
        return 0 if ok else 1
    xt = x if args.batch <= 1 else generators.random_sparse_batch(
        args.batch, m, density=args.x_density, seed=args.seed)
    xt = torch.from_numpy(xt).to(dev)
    # an activation-skip format's exact plan for this X, built once
    plan = torch.as_tensor(fmt.plan(xt.cpu().numpy()), dtype=torch.int32,
                           device=dev) if isinstance(fmt, PlanSkip) else None

    def run(f, xx):
        kw = {} if plan is None else {"plan": plan}
        return f.spmv(xx, **kw) if xx.ndim == 1 else f.spmm(xx, **kw)

    nbytes = format_bytes(fmt)
    op = "spmv" if args.batch <= 1 else f"spmm[B={args.batch}]"
    r = device_time(run, fmt, xt, name=op, bytes_moved=nbytes, nnz=s["nnz"])
    print(f"{r} | {roofline_fraction(nbytes, r.seconds):.3f} of the bytes "
          f"bound on its own bytes ({nbytes / 1e6:.1f} MB streamed vs "
          f"{m * n * 4 / 1e6:.1f} MB dense) on {torch.cuda.get_device_name()}")
    return 0 if ok else 1


def cmd_solve(args) -> int:
    """An iterative solve from ingestion (or a generated 2-D Laplacian) to
    the float64 residual: route, precondition (none, jacobi, chebyshev,
    amg), solve (cg, bicgstab, gmres), check."""
    import numpy as np
    import torch

    from tpusparse_torch import solve as _solve
    from tpusparse_torch.formats.auto import auto_format, matrix_stats_csr
    from tpusparse_torch.formats.csr import CsrMatrix
    from tpusparse_torch.testing.reference import csr_spmm_cpu
    from tpusparse_torch.utils import resolve_device

    dev = resolve_device(_device(args))
    if args.file:
        csr = _load_csr(args.file)
        label = args.file
    else:
        from scipy import sparse as ssp

        side = args.side
        t = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
        lap = (ssp.kron(ssp.eye(side), t) + ssp.kron(t, ssp.eye(side))).tocsr()
        csr = CsrMatrix.from_scipy(lap.astype(np.float32))
        label = f"laplacian2d({side}x{side})"
    m, n = csr.shape
    if m != n:
        print(f"solve needs a square system, got {m}x{n}")
        return 2
    s = matrix_stats_csr(csr)
    fmt = auto_format(csr, stats=s, device=dev)
    print(f"{label}: n={n}, nnz={s['nnz']} -> {type(fmt).__name__}")
    b = np.random.default_rng(args.seed).normal(size=n).astype(np.float32)
    bt = torch.from_numpy(b).to(dev)

    m_inv = None
    if args.precond == "jacobi":
        rows = np.repeat(np.arange(n), csr.row_nnz)
        diag = np.zeros(n, np.float32)
        on = rows == csr.col_idx
        diag[rows[on]] = csr.values[on]
        m_inv = _solve.jacobi_preconditioner(diag)
    elif args.precond == "chebyshev":
        from tpusparse_torch.eig import spectrum_bounds

        lmin, lmax = spectrum_bounds(fmt, device=dev)
        print(f"spectrum bounds [{float(lmin):.3g}, {float(lmax):.3g}]")
        m_inv = _solve.chebyshev_preconditioner(fmt, lmax, lmin=lmin,
                                                degree=args.degree)
    elif args.precond == "amg":
        from tpusparse_torch.amg import (SmoothedAggregationAMG,
                                         smoothed_aggregation)

        t0 = time.perf_counter()
        if args.precond_file:
            m_inv = SmoothedAggregationAMG.load(args.precond_file, device=dev)
            print(f"amg load {time.perf_counter() - t0:.2f} s: {m_inv!r}")
        else:
            m_inv = smoothed_aggregation(csr, degree=args.degree, device=dev)
            print(f"amg setup {time.perf_counter() - t0:.2f} s: {m_inv!r}")
        if args.save_precond:
            t0 = time.perf_counter()
            m_inv.save(args.save_precond)
            print(f"amg saved to {args.save_precond} "
                  f"({time.perf_counter() - t0:.2f} s)")
    solver = {"cg": _solve.cg, "bicgstab": _solve.bicgstab,
              "gmres": _solve.gmres}[args.solver]

    def run():
        t0 = time.perf_counter()
        z, info = solver(fmt, bt, tol=args.tol, m_inv=m_inv)
        res = float(info["resnorm"])            # reading it synchronises
        return z, int(info["iters"]), res, time.perf_counter() - t0

    _, _, _, t_cold = run()
    z, iters, res, t_warm = run()
    # the JAX command's residual: z @ A (A z for the symmetric systems)
    err = float(np.abs(csr_spmm_cpu(z.double().cpu().numpy(), csr) - b).max())
    ok = res <= args.tol * float(np.linalg.norm(b)) * 1.01
    where = "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)
    print(f"{args.solver}+{args.precond}: {iters} iters, resnorm "
          f"{res:.3e}, {t_warm * 1e3:.1f} ms warm ({t_cold:.2f} s cold, "
          f"{where}), max|Az-b| {err:.3e} "
          f"[{'OK' if ok else 'NOT CONVERGED'}]")
    return 0 if ok else 1


def cmd_scaling(args) -> int:
    """Weak or strong scaling of the sharded maps over ranks of this host
    (``bench.scaling``), or ``--model``: the collective cost model."""
    if args.model:
        from tpusparse_torch.bench.commmodel import report

        print(report(m=args.m, n=args.n, batch=args.batch))
        return 0
    import torch

    from tpusparse_torch.bench.scaling import main as scaling_main

    if args.devices == "auto":
        world = 1 if args.cpu else torch.cuda.device_count()
    else:
        world = max(int(s) for s in args.devices.split(","))
    return scaling_main(["--world", str(world), "--mode", args.mode,
                         "--kernel", args.kernel, "--partition",
                         args.partition, "--base-m", str(args.m),
                         "--base-n", str(args.n), "--density",
                         str(args.density), "--device",
                         "cpu" if args.cpu else "cuda"])


def cmd_gallery(argv) -> int:
    """Real-topology gallery and router regret (``bench/gallery.py``)."""
    from tpusparse_torch.bench.gallery import main as gallery_main

    return gallery_main(argv)


def cmd_dynamic(argv) -> int:
    """Dynamic-activation serving bench (``bench/dynamic.py``)."""
    from tpusparse_torch.bench.dynamic import main as dynamic_main

    return dynamic_main(argv)


def cmd_scale(argv) -> int:
    """GB-scale unstructured run (``bench/scale.py``)."""
    from tpusparse_torch.bench.scale import main as scale_main

    return scale_main(argv)


_FORWARD = {"gallery": cmd_gallery, "dynamic": cmd_dynamic,
            "scale": cmd_scale}
_HELP = {
    "check": "every registry kernel against the float64 oracle",
    "bench": "time the registry's kernels on a workload",
    "headline": "the headline result as one JSON line",
    "profile": "device time of each CUDA kernel on bench/profile.py's paths",
    "scaling": "scaling of the sharded maps over ranks, or --model",
    "report": "the measured report in Markdown",
    "mtx": "route, check and time a MatrixMarket matrix",
    "solve": "an iterative solve, checked against the float64 residual",
    "gallery": "real-topology gallery and router regret (its own --help)",
    "dynamic": "dynamic-activation serving bench (its own --help)",
    "scale": "GB-scale unstructured run (its own --help)",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # the benches parse their own arguments (argparse's REMAINDER cannot
    # forward leading optionals, so they are dispatched before it)
    if argv and argv[0] in _FORWARD:
        return _FORWARD[argv[0]](argv[1:])
    parser = argparse.ArgumentParser(prog="python -m tpusparse_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in _FORWARD:
        sub.add_parser(name, help=_HELP[name])
    for name, fn in [("check", cmd_check), ("bench", cmd_bench),
                     ("headline", cmd_headline), ("profile", cmd_profile),
                     ("scaling", cmd_scaling), ("report", cmd_report),
                     ("mtx", cmd_mtx), ("solve", cmd_solve)]:
        p = sub.add_parser(name, help=_HELP[name])
        p.set_defaults(fn=fn)
        if name == "solve":
            p.add_argument("--file", default=None,
                           help="MatrixMarket .mtx path (default: a "
                                "generated 2-D Laplacian)")
            p.add_argument("--side", type=int, default=128,
                           help="grid side of the generated Laplacian")
            p.add_argument("--solver", default="cg",
                           choices=["cg", "bicgstab", "gmres"])
            p.add_argument("--precond", default="none",
                           choices=["none", "jacobi", "chebyshev", "amg"])
            p.add_argument("--degree", type=int, default=2,
                           help="chebyshev / AMG smoother polynomial degree")
            p.add_argument("--save-precond", default=None, metavar="NPZ",
                           help="with --precond amg: save the hierarchy")
            p.add_argument("--precond-file", default=None, metavar="NPZ",
                           help="with --precond amg: load a saved "
                                "hierarchy instead of building one")
            p.add_argument("--tol", type=float, default=1e-5)
            p.add_argument("--seed", type=int, default=0)
            p.add_argument("--cpu", action="store_true")
        elif name == "mtx":
            p.add_argument("file", help="MatrixMarket .mtx path")
            p.add_argument("--batch", type=int, default=1)
            p.add_argument("--x-density", type=float, default=0.5)
            p.add_argument("--seed", type=int, default=0)
            p.add_argument("--no-time", action="store_true",
                           help="stop after the float64-oracle check")
            p.add_argument("--cpu", action="store_true")
        elif name == "report":
            p.add_argument("--sections", default=None,
                           help="comma list: canonical,powerlaw,lowdensity,"
                                "structured,spmm,tcsr,floors,reduced,"
                                "crossover,training,solver (default all)")
            p.add_argument("--cpu", action="store_true")
        elif name == "profile":
            p.add_argument("--cpu", action="store_true")
        else:
            _add_workload_args(p)
        if name == "bench":
            p.add_argument("--format", default="text",
                           choices=["text", "json", "csv"])
        if name == "scaling":
            p.add_argument("--mode", default="weak",
                           choices=["weak", "strong"])
            p.add_argument("--kernel", default="dense",
                           choices=["dense", "sell"])
            p.add_argument("--partition", default="n",
                           choices=["n", "m", "ring"])
            p.add_argument("--devices", default="auto",
                           help="the largest rank count to sweep (or a "
                                "comma list: its largest), or 'auto': "
                                "every card")
            p.add_argument("--model", action="store_true",
                           help="print the collective cost model instead "
                                "of measuring")
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
