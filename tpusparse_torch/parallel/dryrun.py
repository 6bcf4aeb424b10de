"""The sharded maps' case list, for a mesh of any size: the port of the JAX
package's ``dryrun_multichip`` partition list (``__graft_entry__.py``).

Every case runs one public sharded call on operands that every rank makes
from the same seeds, and is held to a float64 oracle. Two sizes:

- ``"small"``: the JAX list's own, ``m = n = 128 * D`` at D ranks, a band
  of that matrix for DIA, and two stencils (64 x 64 and 16^3, 27 points)
  whose slabs of 1024 positions at D = 4 run K8 with halo strips;
- ``"full"``: the port's paths at full width: the headline 4096^2 (d = 0.5)
  for dense, SELL, BSR and AWSP, the 8192^2 powerlaw (d = 0.15) for RSELL
  and binned SELL, blockpruned-4096 for TCSR, the 1M-unknown Laplacian and
  HPCG's 27-point stencil at 104^3 for DIA.

SpMM cases (``2d``) take 4 batch rows (small) or 8 (full) over a
``("b", "n")`` mesh; the others one vector.

Three solver and training cases close the list (``solver_cases``): a grid
AMG solve through ``shard(mesh)`` (DIA levels through the halo partition),
a greedy AMG solve built with ``smoothed_aggregation(..., mesh=mesh)``
(ragged-SELL column shards, K4), and two SGD steps of
``trainable_linear_sharded`` on its weights and its activations. Small:
the JAX list's side-24 Laplacian and ``mesh_csr(24, 24, seed=9)``, both
with ``dense_cutoff=128`` (so that the Laplacian's finest level is DIA and
goes through the halo partition), and the (128 D)^2 matrix with one vector; full: the
1M-unknown Laplacian for both solves (default ``dense_cutoff``) and the
headline 4096^2 with 8 batch rows. Each is held to the unsharded build:
the same CG iterations, z within 1e-5 (grid) or a float64 relative
residual within max(2 x the unsharded one, 1e-5) (greedy), and a falling
loss.

Run as a program, it is the multi-card dry run of the JAX package's
``dryrun_multichip(n_devices)``: ``python -m tpusparse_torch.parallel.dryrun
--world 4`` starts 4 ranks on this host (rank r on ``cuda:r`` over NCCL, or
``--device cpu`` for gloo on the CPU), runs the list and ``comm``'s
collectives on each, then a CG through the halo partition; it checks every
case on every rank against the oracle (1e-3), that the ranks agree bit for
bit, and that the CG takes the unsharded K8 CG's iterations and bits. It
prints one JSON line and exits 0 only if every check held.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import Any, Callable

import numpy as np
import torch

from tpusparse_torch.testing import generators, reference

SKEW = dict(m=8192, n=8192, density=0.15, distribution="powerlaw", seed=0)
BLOCKY = dict(m=4096, n=4096, block=128, keep_frac=0.3, fill=0.5, seed=9)
STENCILS = {"small": {"laplace": ((64, 64), None),
                      "stencil27": ((16, 16, 16), 27)},
            "full": {"laplace": ((1024, 1024), None),
                     "stencil27": ((104, 104, 104), 27)}}


def operands(size: str, d: int) -> dict[str, Any]:
    """The seeded host operands of every case (numpy; CSRs for DIA)."""
    if size == "small":
        m = 128 * d
        a = generators.random_sparse_matrix(m, m, density=0.5, seed=0)
        x = generators.random_sparse_vector(m, density=0.5, seed=0)
        xb = generators.random_sparse_batch(4, m, density=0.5, seed=1)
        ops = dict(a=a, x=x, xb=xb, a_skew=a, x_skew=x, a_blocky=a,
                   x_blocky=x, band=np.tril(np.triu(a, -3), 5))
    elif size == "full":
        m = 4096
        a = generators.random_sparse_matrix(m, m, density=0.5, seed=0)
        ops = dict(
            a=a, x=generators.random_sparse_vector(m, 0.5, 0),
            xb=generators.random_sparse_batch(8, m, 0.5, 0),
            a_skew=generators.random_sparse_matrix(
                SKEW["m"], SKEW["n"], density=SKEW["density"],
                seed=SKEW["seed"], distribution=SKEW["distribution"]),
            x_skew=generators.random_sparse_vector(SKEW["m"], 0.5,
                                                   SKEW["seed"]),
            a_blocky=generators.block_pruned_matrix(
                BLOCKY["m"], BLOCKY["n"], block=BLOCKY["block"],
                keep_frac=BLOCKY["keep_frac"], fill=BLOCKY["fill"],
                seed=BLOCKY["seed"]),
            x_blocky=generators.random_sparse_vector(BLOCKY["m"], 0.5, 0),
            band=None)
    else:
        raise ValueError(f"unknown size {size!r}")
    ops["size"] = size
    ops["stencils"] = {name: generators.stencil_csr(dims, points=pts)
                       for name, (dims, pts) in STENCILS[size].items()}
    ops["x_stencil"] = {name: generators.random_sparse_vector(
        c.shape[0], 0.5, 0) for name, c in ops["stencils"].items()}
    return ops


def host_packs(ops: dict[str, Any], d: int, d2: int | None = None,
               dia: dict | None = None) -> dict[str, Any]:
    """Every case's host pack for D shards, and for ``d2`` shards along
    ``"n"`` of the SpMM cases' 2-D mesh (formats on the CPU, shard packs as
    numpy). ``dia``: the stencils' host ``DiaMatrix`` packs, when made
    already."""
    from tpusparse_torch.formats import (AwspMatrix, BinnedSellMatrix,
                                         DiaMatrix, SellMatrix)
    from tpusparse_torch.formats.rsell import rsell_shard_pack
    from tpusparse_torch.parallel.sparse import (bsr_shard_pack,
                                                 tcsr_shard_pack)

    a = ops["a"]
    cpu = dict(device="cpu")
    packs = dict(
        sell=SellMatrix.from_dense(a, **cpu),
        sell_ragged=SellMatrix.from_dense(a[:, :a.shape[1] - 128], **cpu),
        bsr={p: bsr_shard_pack(a, d, partition=p)
             for p in ("n", "m", "ring")},
        awsp=AwspMatrix.from_dense(a, g=1, **cpu),
        binned=BinnedSellMatrix.from_dense(ops["a_skew"], **cpu),
        rsell={s: rsell_shard_pack(ops["a_skew"], d, assignment=s)
               for s in ("balance", "sorted")},
        tcsr=tcsr_shard_pack(ops["a_blocky"], d),
        dia=dict(dia) if dia is not None else {
            name: DiaMatrix.from_csr(c, **cpu)
            for name, c in ops["stencils"].items()})
    if d2 is not None:
        packs["bsr_2d"] = bsr_shard_pack(a, d2)
    if ops["band"] is not None:
        packs["dia"]["band"] = DiaMatrix.from_dense(ops["band"], **cpu)
    return packs


def sharded_calls(ops: dict[str, Any], packs: dict[str, Any], mesh,
                  mesh2=None) -> dict[str, Callable[[], torch.Tensor]]:
    """Each case's sharded call on ``mesh`` (``mesh2``: the ``("b", "n")``
    mesh of the SpMM cases, which are left out without one)."""
    from tpusparse_torch.parallel import spmv_sharded
    from tpusparse_torch.parallel.sparse import (awsp_spmm_sharded,
                                                 binned_spmm_sharded,
                                                 bsr_spmm_sharded,
                                                 dia_spmm_sharded,
                                                 rsell_spmm_sharded,
                                                 sell_spmm_sharded,
                                                 tcsr_spmm_sharded)

    a, x = ops["a"], ops["x"]
    calls: dict[str, Callable[[], torch.Tensor]] = {}
    for p in ("n", "m", "ring"):
        calls[f"dense[{p}]"] = lambda p=p: spmv_sharded(a, x, mesh, p)
    for p in ("n", "m", "ring"):
        calls[f"sell[{p}]"] = \
            lambda p=p: sell_spmm_sharded(packs["sell"], x, mesh, p)
    calls["sell[n ragged]"] = \
        lambda: sell_spmm_sharded(packs["sell_ragged"], x, mesh, "n")
    for p in ("n", "m", "ring"):
        calls[f"bsr[{p}]"] = \
            lambda p=p: bsr_spmm_sharded(packs["bsr"][p], x, mesh)
    for p in ("n", "m", "ring"):
        calls[f"awsp[{p}]"] = \
            lambda p=p: awsp_spmm_sharded(packs["awsp"], x, mesh, p)
    calls["binned[n]"] = \
        lambda: binned_spmm_sharded(packs["binned"], ops["x_skew"], mesh)
    for s in ("balance", "sorted"):
        calls[f"rsell[{s}]"] = lambda s=s: rsell_spmm_sharded(
            packs["rsell"][s], ops["x_skew"], mesh)
    calls["tcsr[n]"] = \
        lambda: tcsr_spmm_sharded(packs["tcsr"], ops["x_blocky"], mesh)
    for name, dm in packs["dia"].items():
        xd = x if name == "band" else ops["x_stencil"][name]
        for p in ("halo", "n"):
            calls[f"dia[{p}] {name}"] = \
                lambda dm=dm, xd=xd, p=p: dia_spmm_sharded(dm, xd, mesh, p)
    if mesh2 is not None:
        xb = ops["xb"]
        calls["sell[2d]"] = \
            lambda: sell_spmm_sharded(packs["sell"], xb, mesh2, "2d")
        calls["bsr[2d]"] = \
            lambda: bsr_spmm_sharded(packs["bsr_2d"], xb, mesh2)
    return calls


def oracle(ops: dict[str, Any], case: str) -> np.ndarray:
    """The float64 product each case must give (cast to fp32)."""
    fam = case.split("[")[0]
    if case.startswith("dia["):
        name = case.split()[-1]
        if name == "band":
            return reference.sgemv_cpu(ops["x"], ops["band"])
        at = ops["stencils"][name].to_scipy().T.tocsr().astype(np.float64)
        return (at @ ops["x_stencil"][name].astype(np.float64)
                ).astype(np.float32)
    if case.endswith("[2d]"):
        return reference.sgemm_cpu(ops["xb"], ops["a"])
    if case == "sell[n ragged]":
        a = ops["a"]
        return reference.sgemv_cpu(ops["x"], a[:, :a.shape[1] - 128])
    if fam in ("binned", "rsell"):
        return reference.sgemv_cpu(ops["x_skew"], ops["a_skew"])
    if fam == "tcsr":
        return reference.sgemv_cpu(ops["x_blocky"], ops["a_blocky"])
    return reference.sgemv_cpu(ops["x"], ops["a"])


def collectives(mesh) -> dict[str, torch.Tensor]:
    """``comm``'s four collectives over the mesh's ``"n"`` group, each on a
    known input: rank r holds ``arange(4 * D) + 100 * r`` (fp32) on its
    device. ``expected_collectives`` gives what each must return."""
    from tpusparse_torch.parallel import comm
    from tpusparse_torch.parallel.mesh import axis_size, mesh_device

    g, d = mesh.get_group("n"), axis_size(mesh, "n")
    me, dev = mesh.get_local_rank("n"), mesh_device(mesh)
    v = torch.arange(4 * d, dtype=torch.float32, device=dev) + 100 * me
    return {"all_gather_x": comm.all_gather_x(v[:4], g),
            "all_gather_x_axis1": comm.all_gather_x(v.view(2, -1)[:, :2],
                                                    g, axis=1),
            "reduce_scatter_y": comm.reduce_scatter_y(v, g),
            "psum_y": comm.psum_y(v, g),
            "ring_shift+1": comm.ring_shift(v, g, 1),
            "ring_shift-1": comm.ring_shift(v, g, -1)}


def expected_collectives(d: int, me: int) -> dict[str, np.ndarray]:
    """What ``collectives`` must return on rank ``me`` of ``d``."""
    base = np.arange(4 * d, dtype=np.float32)
    held = [base + 100 * r for r in range(d)]
    total = sum(held)
    return {"all_gather_x": np.concatenate([h[:4] for h in held]),
            "all_gather_x_axis1": np.concatenate(
                [h.reshape(2, -1)[:, :2] for h in held], axis=1),
            "reduce_scatter_y": total[4 * me:4 * (me + 1)],
            "psum_y": total,
            "ring_shift+1": held[(me - 1) % d],
            "ring_shift-1": held[(me + 1) % d]}


SOLVER_SIZES = {"small": dict(side=24, fem=(24, 24, 9), dense_cutoff=128),
                "full": dict(side=1024, fem=None, dense_cutoff=2048)}
GREEDY_TOL = 1e-6            # the JAX list's greedy solve
TRAIN_LR, X_LR = 1e-3, 1e-2  # the JAX list's train step


def solver_operands(size: str, ops: dict[str, Any]) -> dict[str, Any]:
    """The solver cases' seeded host operands: the grid Laplacian, the
    greedy case's matrix (the FEM graph, or the Laplacian at full size),
    their right-hand sides, and the train step's matrix and x (the list's
    ``a`` with its vector, or its 8 batch rows at full size)."""
    cfg = SOLVER_SIZES[size]
    lap = generators.stencil_csr((cfg["side"], cfg["side"]))
    fem = lap if cfg["fem"] is None else generators.mesh_csr(
        cfg["fem"][0], cfg["fem"][1], seed=cfg["fem"][2])
    return dict(lap=lap, fem=fem, dense_cutoff=cfg["dense_cutoff"],
                b_grid=generators.random_sparse_vector(lap.shape[0], 0.5, 2),
                b_greedy=generators.random_sparse_vector(fem.shape[0], 0.5,
                                                         3),
                a_train=ops["a"],
                x_train=ops["x"] if size == "small" else ops["xb"])


def _grid(sops, dev, mesh=None):
    from tpusparse_torch.amg import smoothed_aggregation

    amg = smoothed_aggregation(sops["lap"], aggregation="grid", device=dev,
                               dense_cutoff=sops["dense_cutoff"])
    return amg if mesh is None else amg.shard(mesh)


def _greedy(sops, dev, mesh=None):
    from tpusparse_torch.amg import smoothed_aggregation

    return smoothed_aggregation(sops["fem"], dense_cutoff=sops["dense_cutoff"],
                                device=dev, mesh=mesh)


def _solve(amg, b, tol, dev) -> tuple[np.ndarray, int]:
    z, info = amg.solve(torch.from_numpy(b).to(dev), tol=tol)
    return z.cpu().numpy(), int(info["iters"])


def solver_cases(sops: dict[str, Any], mesh,
                 train: bool = True) -> dict[str, Any]:
    """The three cases on ``mesh`` (the AMG solves alone without
    ``train``): each AMG solve's z and iterations and its levels' formats;
    the train step's two losses, the activations after the first step, and
    this rank's ``vals`` and ``vals_t`` shards after ``resync`` (with their
    drift from the re-tied copy before it)."""
    from tpusparse_torch.autodiff import trainable_linear_sharded
    from tpusparse_torch.formats import CsrMatrix
    from tpusparse_torch.parallel.mesh import mesh_device

    dev = mesh_device(mesh)
    out: dict[str, Any] = {}
    grid = _grid(sops, dev, mesh)
    out["grid_z"], out["grid_iters"] = _solve(grid, sops["b_grid"], CG_TOL,
                                              dev)
    out["grid_levels"] = [type(lv.a).__name__ for lv in grid.levels]
    greedy = _greedy(sops, dev, mesh)
    out["greedy_z"], out["greedy_iters"] = _solve(greedy, sops["b_greedy"],
                                                  GREEDY_TOL, dev)
    out["greedy_levels"] = [lv.fmt for lv in greedy.levels]
    if not train:
        return out
    ap, params, _, resync = trainable_linear_sharded(
        CsrMatrix.from_dense(sops["a_train"]), mesh)
    n = sops["a_train"].shape[1]
    x = torch.from_numpy(sops["x_train"]).to(dev)
    losses = []
    for step in range(2):
        xr = x.clone().requires_grad_()
        loss = (ap(params, xr) ** 2).sum() / n
        loss.backward()
        with torch.no_grad():
            for p in params.values():
                p -= TRAIN_LR * p.grad
                p.grad = None
            x = x - X_LR * xr.grad
        losses.append(float(loss))
        if step == 0:
            out["train_x1"] = x.cpu().numpy()
    before = params["vals_t"].detach().clone()
    resync(params)
    out["train_loss"] = np.array(losses)
    out["train_drift"] = float((before - params["vals_t"]).abs().max())
    out["train_vals"] = params["vals"].detach().cpu().numpy()
    out["train_vals_t"] = params["vals_t"].detach().cpu().numpy()
    return out


def solver_reference(sops: dict[str, Any], dev) -> dict[str, Any]:
    """The unsharded AMG solves of ``solver_cases`` on ``dev``."""
    ref = {}
    ref["grid_z"], ref["grid_iters"] = _solve(_grid(sops, dev),
                                              sops["b_grid"], CG_TOL, dev)
    ref["greedy_z"], ref["greedy_iters"] = _solve(
        _greedy(sops, dev), sops["b_greedy"], GREEDY_TOL, dev)
    return ref


def relres(csr, z: np.ndarray, b: np.ndarray) -> float:
    """||A z - b|| / ||b|| in float64."""
    sp = csr.to_scipy().astype(np.float64)
    b = b.astype(np.float64)
    return float(np.linalg.norm(sp @ z.astype(np.float64) - b)
                 / np.linalg.norm(b))


def judge_solver(sops: dict[str, Any], got: dict[str, Any],
                 ref: dict[str, Any]) -> dict[str, Any]:
    """The solver cases against the unsharded build: ``ok`` and what it
    rests on."""
    r_g, r_0 = (relres(sops["fem"], z, sops["b_greedy"])
                for z in (got["greedy_z"], ref["greedy_z"]))
    rec = {"grid_iters": [int(got["grid_iters"]), int(ref["grid_iters"])],
           "grid_dz": float(np.abs(got["grid_z"] - ref["grid_z"]).max()),
           "grid_res": relres(sops["lap"], got["grid_z"], sops["b_grid"]),
           "greedy_iters": [int(got["greedy_iters"]),
                            int(ref["greedy_iters"])],
           "greedy_relres": [r_g, r_0],
           "train_loss": [float(v) for v in got["train_loss"]]}
    rec["ok"] = bool(
        rec["grid_iters"][0] == rec["grid_iters"][1]
        and rec["grid_dz"] <= CG_TOL and rec["grid_res"] <= ATOL
        and rec["greedy_iters"][0] == rec["greedy_iters"][1]
        and r_g <= max(2.0 * r_0, CG_TOL)
        and rec["train_loss"][1] < rec["train_loss"][0])
    return rec


ATOL = 1e-3
CG_TOL = 1e-5


def check_rank(rank: int, world: int, port: int, size: str, device: str,
               out_dir: str) -> int:
    """One rank of ``main``'s world: every case and the collectives, then
    the halo CG (rank 0 also the unsharded K8 CG); its y's to
    ``out_dir/rank<r>.npz``, its record to ``rank<r>.json``."""
    import torch.distributed as dist

    from tpusparse_torch.formats import DiaMatrix
    from tpusparse_torch.parallel import initialize, make_mesh
    from tpusparse_torch.parallel.comm import transport
    from tpusparse_torch.parallel.sparse import dia_spmm_sharded
    from tpusparse_torch.solve import cg

    dev = initialize(f"127.0.0.1:{port}", world, rank,
                     device=None if device == "cuda" else device)
    mesh = make_mesh({"n": world})
    mesh2 = make_mesh({"b": 2, "n": world // 2}) if world % 2 == 0 else None
    ops = operands(size, world)
    packs = host_packs(ops, world, None if mesh2 is None else world // 2)
    got = collectives(mesh)
    rec: dict[str, Any] = {
        "rank": rank, "device": str(dev),
        "transport": transport(mesh.get_group("n"), dev),
        "comm_ok": all(np.array_equal(got[k].cpu().numpy(), v) for k, v in
                       expected_collectives(world, rank).items())}
    ys, errs = {}, {}
    for case, call in sharded_calls(ops, packs, mesh, mesh2).items():
        ys[case] = call().cpu().numpy()
        errs[case] = float(np.abs(ys[case].astype(np.float64)
                                  - oracle(ops, case)).max())
    rec["errs"] = errs
    dm = packs["dia"]["laplace"]
    b = torch.from_numpy(generators.random_sparse_vector(dm.shape[0], 0.5, 0)
                         ).to(dev)
    z, info = cg(lambda v: dia_spmm_sharded(dm, v, mesh, "halo"), b,
                 tol=CG_TOL)
    rec["cg_iters"] = int(info["iters"])
    sops = solver_operands(size, ops)
    solved = solver_cases(sops, mesh)
    rec["solver_levels"] = {k: solved.pop(k) for k in ("grid_levels",
                                                       "greedy_levels")}
    if rank == 0:
        d0 = DiaMatrix(dm.offsets, dm.vals.to(dev), dm.shape, dm.nnz,
                       sym=dm.sym)
        z0, info0 = cg(d0, b, tol=CG_TOL)
        rec["cg_unsharded_iters"] = int(info0["iters"])
        rec["cg_same_bits"] = bool(torch.equal(z, z0))
        rec["solver"] = judge_solver(sops, solved,
                                     solver_reference(sops, dev))
    shared = {k: v for k, v in solved.items()
              if k not in ("train_vals", "train_vals_t", "train_drift")}
    ys.update({f"solver:{k}": np.asarray(v) for k, v in shared.items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **ys)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def run(world: int, size: str = "full", device: str = "cuda",
        timeout: float = 900.0) -> dict[str, Any]:
    """Start ``world`` ranks of ``check_rank`` on this host, wait, and
    judge their records; ``ok`` is True only if every check held."""
    import tempfile

    if device == "cuda":        # once here, not once a rank
        from tpusparse_torch.kernels import _build

        _build.build()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpusparse_torch.parallel.dryrun",
             "--rank", str(r), "--world", str(world), "--port", str(port),
             "--size", size, "--device", device, "--out", out_dir],
            env={**env, "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        failed = {r: log[-3000:] for r, (p, log) in enumerate(zip(procs, logs))
                  if p.returncode != 0}
        if failed:
            return {"ok": False, "world": world, "failed_ranks": failed}
        recs = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
                for r in range(world)]
        ys = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
              for r in range(world)]
    same = all(np.array_equal(y[k], ys[0][k]) for y in ys for k in ys[0])
    worst = max(e for rc in recs for e in rc["errs"].values())
    cg_ok = recs[0]["cg_same_bits"] and all(
        rc["cg_iters"] == recs[0]["cg_unsharded_iters"] for rc in recs)
    solver = recs[0]["solver"]
    return {"ok": bool(same and worst <= ATOL and cg_ok and solver["ok"]
                       and all(rc["comm_ok"] for rc in recs)),
            "world": world, "size": size,
            "cases": len(recs[0]["errs"]) + len(SOLVER_CASES),
            "solver": solver, "solver_levels": recs[0]["solver_levels"],
            "transport": recs[0]["transport"],
            "ranks_agree": same, "worst_oracle_err": worst,
            "comm_ok": [rc["comm_ok"] for rc in recs],
            "cg_iters": [rc["cg_iters"] for rc in recs],
            "cg_unsharded_iters": recs[0]["cg_unsharded_iters"],
            "cg_same_bits": recs[0]["cg_same_bits"],
            "devices": [rc["device"] for rc in recs]}


SOLVER_CASES = ("amg[grid]", "amg[greedy]", "train")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the sharded maps' dry run "
                                 "on WORLD ranks of this host")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--size", default="full", choices=("small", "full"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:r, NCCL) or cpu (gloo)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return check_rank(args.rank, args.world, args.port, args.size,
                          args.device, args.out)
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"dryrun: {args.world} ranks need {args.world} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    rec = run(args.world, args.size, args.device)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
