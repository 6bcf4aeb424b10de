"""The port's parallel layer (``tpusparse_torch/parallel``) against the JAX
package's, on the CPU.

- One spawned world of 4 gloo ranks (this file run as a script is the
  worker) runs the ``dryrun_multichip`` partition list at its own sizes
  (``parallel.dryrun``, ``"small"``: 512^2, a band of it, and two stencils
  whose slabs run K8's plain version with halo strips), on meshes
  ``{"n": 4}`` and ``{"b": 2, "n": 2}``. Every rank must return the same
  full y; each case is held to the JAX package's sharded function on a
  4-device mesh of the virtual CPU devices within 1e-4 and to the float64
  oracle within 1e-3. The worker also checks the idempotent and the
  contradictory ``initialize``, ``process_slab``, ``host_local_matrix``
  and ``comm``'s collectives (``dryrun.collectives``) exactly.
- World size 1 in this process (gloo on the CPU): the same list against
  the oracle.
- ``process_slab`` and ``host_local_matrix`` against the JAX package's.
- The dry-run program (``python -m tpusparse_torch.parallel.dryrun``) at 2
  gloo ranks, started beside the world, with its three solver and training
  cases, and the scaling program (``python -m
  tpusparse_torch.bench.scaling``) at 2.
- The rest of the parallel layer, in the same world (``_more``):
  ``linear_map_sharded`` on all four partitions and
  ``trainable_linear_sharded`` on a sorted and an unsorted CSR, held to the
  JAX package's sharded functions (4 virtual devices) within 1e-4 and to
  the port's unsharded functions within 1e-5, with ``resync`` exact; the
  sharded AMG placements (grid, block, greedy ``mesh=``) against the
  unsharded builds, level 0's halo apply counted collective by
  collective; the dry run's solver cases; the four sweeps of
  ``tests/test_scaling.py``; and every sharded call's collectives, held to
  ``bench.commmodel``'s kinds and bytes.

The JAX calls (Pallas interpret mode, two RSELL calls among them) run once
in module-scoped fixtures, the world once a file.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ATOL_JAX = 1e-4
ATOL_ORACLE = 1e-3


def _worker(port: int, rank: int, world: int, out: str) -> int:
    """One rank of the spawned world: the case list, saved to
    ``out/rank<r>.npz``."""
    import torch.distributed as dist

    from tpusparse_torch.parallel import (dryrun, host_local_matrix,
                                          initialize, make_mesh,
                                          process_slab)
    from tpusparse_torch.testing import generators

    kw = dict(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
              process_id=rank, device="cpu")
    dev = initialize(**kw)
    assert initialize(**kw) == dev                 # idempotent re-call
    assert initialize(device="cpu") == dev         # the live world
    try:
        initialize(num_processes=world + 1, process_id=rank, device="cpu")
    except RuntimeError:
        pass
    else:
        raise AssertionError("a contradictory initialize did not raise")
    mesh = make_mesh({"n": world})
    mesh2 = make_mesh({"b": 2, "n": world // 2})
    ops = dryrun.operands("small", world)
    packs = dryrun.host_packs(ops, world, world // 2)
    res = {name: call().numpy() for name, call in
           dryrun.sharded_calls(ops, packs, mesh, mesh2).items()}
    got = dryrun.collectives(mesh)
    for name, want in dryrun.expected_collectives(world, rank).items():
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    assert str(dev) == "cpu"
    m, n = 256, 512
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=11)
    rs, cs = process_slab(m, n)
    np.testing.assert_array_equal(
        host_local_matrix(m, n, density=0.5, seed=11), a[rs, cs])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    arrays, rec = _more(mesh, mesh2, ops)
    np.savez(os.path.join(out, f"more{rank}.npz"), **arrays)
    with open(os.path.join(out, f"more{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


# -- the rest of the parallel layer, in the same world ----------------------

LR = 1e-2


def _target(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _shuffled_rows(c, seed):
    """The same CSR with each row's entries in a random order (the JAX
    test's procedure); ``c`` is either package's ``CsrMatrix``."""
    rng = np.random.default_rng(seed)
    ci, vals = np.array(c.col_idx), np.array(c.values)
    for r in range(len(c.row_ptr) - 1):
        lo, hi = int(c.row_ptr[r]), int(c.row_ptr[r + 1])
        perm = rng.permutation(hi - lo)
        ci[lo:hi], vals[lo:hi] = ci[lo:hi][perm], vals[lo:hi][perm]
    assert not np.array_equal(ci, c.col_idx)
    return type(c)(shape=c.shape, row_ptr=c.row_ptr, col_idx=ci, values=vals)


def train_operands():
    """The training cases' seeded operands (numpy): ``linear_map_sharded``
    on a 512 x 1024 matrix with 4 batch rows, and
    ``trainable_linear_sharded`` on a sorted 512 x 1024 case (one vector)
    and on an unsorted 512 x 1152 one (3 batch rows; 9 column groups, so
    the shards pad to 12), each with a fixed target t of the loss
    sum(y * t). (tests/test_autodiff.py's seeds at half its widths: the
    JAX calls run in Pallas interpret mode, ~10 s each at its widths.)"""
    from tpusparse_torch.testing import generators as g

    return {
        "lm": (g.random_sparse_matrix(512, 1024, density=0.25, seed=33),
               g.random_sparse_batch(4, 512, density=0.5, seed=34),
               _target((4, 1024), 35)),
        "sorted": (g.random_sparse_matrix(512, 1024, density=0.2, seed=41),
                   g.random_sparse_vector(512, density=0.5, seed=42),
                   _target(1024, 46)),
        "unsorted": (g.random_sparse_matrix(512, 1152, density=0.2, seed=44),
                     g.random_sparse_batch(3, 512, density=0.5, seed=45),
                     _target((3, 1152), 47)),
    }


def _lap2d(side):
    from tpusparse_torch.testing import generators

    return generators.stencil_csr((side, side))


def _chain(n):
    from scipy import sparse as ssp

    return ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                     shape=(n, n)).tocsr().astype(np.float32)


def amg_operands():
    """The sharded AMG cases of tests/test_parallel_amg.py: (matrix, b,
    build keywords, CG tol) each."""
    from tpusparse_torch.testing import generators

    side, n_chain = 48, 4096
    return {
        "grid": (_lap2d(side), np.random.default_rng(0).normal(
            size=side * side).astype(np.float32),
            dict(aggregation="grid"), 1e-5),
        "block": (_chain(n_chain), np.random.default_rng(1).normal(
            size=n_chain).astype(np.float32), {}, 1e-5),
        "greedy": (generators.mesh_csr(48, 48, seed=4),
                   np.random.default_rng(1).uniform(-1, 1, 2304)
                   .astype(np.float32), dict(dense_cutoff=512), 1e-6),
    }


def comm_operands():
    """The model's cases: dense and SELL at 1024^2, DIA on a 64 x 64
    stencil (K8's strips at D = 4), a 1024^2 band (the shifted form) and a
    symmetric 3-offset matrix, and a training step at 1024^2."""
    from tpusparse_torch.testing import generators as g

    rng = np.random.default_rng(4)
    sym = np.zeros((1024, 1024), np.float32)
    ii, jj = np.indices(sym.shape)
    for off in (0, 1, 3):
        band = (ii - jj) == off
        sym[band] = rng.normal(size=int(band.sum())).astype(np.float32)
    sym = sym + np.tril(sym, -1).T
    a3 = g.random_sparse_matrix(1024, 1024, density=0.5, seed=3)
    return {"a1": g.random_sparse_matrix(1024, 1024, density=0.5, seed=1),
            "x1": g.random_sparse_vector(1024, density=0.5, seed=1),
            "a2": g.random_sparse_matrix(1024, 1024, density=0.5, seed=2),
            "x2": g.random_sparse_vector(1024, density=0.5, seed=2),
            "band": np.tril(np.triu(a3, -3), 5), "sym": sym,
            "x3": g.random_sparse_vector(1024, density=0.5, seed=3),
            "stencil": g.stencil_csr((64, 64)),
            "x4": g.random_sparse_vector(4096, density=0.5, seed=4),
            "a5": g.random_sparse_matrix(1024, 1024, density=0.3, seed=5),
            "x5": g.random_sparse_vector(1024, density=0.5, seed=5)}


SCALING = {  # tests/test_scaling.py's four sweeps
    "weak_dense_n": dict(mode="weak", kernel="dense", partition="n",
                         base_m=256, base_n=256, device_counts=(1, 2, 4)),
    "strong_sell_m": dict(mode="strong", kernel="sell", partition="m",
                          base_m=512, base_n=256, device_counts=(1, 2)),
    "weak_dense_ring": dict(mode="weak", kernel="dense", partition="ring",
                            base_m=256, base_n=256, device_counts=(1, 2)),
    "strong_dense_n_from_2": dict(mode="strong", kernel="dense",
                                  partition="n", base_m=256, base_n=512,
                                  device_counts=(2, 4)),
}


def _more(mesh, mesh2, ops):
    """This rank's part of the rest of the parallel layer: (arrays for
    npz, a JSON record)."""
    import torch

    from tpusparse_torch import (SellMatrix, linear_map_sharded,
                                 trainable_linear_sharded)
    from tpusparse_torch.amg import smoothed_aggregation
    from tpusparse_torch.bench.commmodel import CollectiveLog
    from tpusparse_torch.bench.scaling import sweep_scaling
    from tpusparse_torch.formats import CsrMatrix, DiaMatrix
    from tpusparse_torch.parallel import dryrun, spmv_sharded
    from tpusparse_torch.parallel.sparse import (dia_spmm_sharded,
                                                 sell_spmm_sharded)

    arrays, rec = {}, {}
    tr = train_operands()
    a, xb, t = tr["lm"]
    s = SellMatrix.from_dense(a, device="cpu")
    s_t = SellMatrix.from_dense(np.ascontiguousarray(a.T), device="cpu")
    for p in ("n", "m", "ring", "2d"):
        f = linear_map_sharded(s, s_t, mesh2 if p == "2d" else mesh, p)
        x = torch.from_numpy(xb).requires_grad_()
        y = f(x)
        (y * torch.from_numpy(t)).sum().backward()
        arrays[f"lm_y[{p}]"] = y.detach().numpy()
        arrays[f"lm_dx[{p}]"] = x.grad.numpy()
    try:
        linear_map_sharded(s, s_t, mesh, "diagonal")
    except ValueError as e:
        rec["bad_partition"] = str(e)
    for case in ("sorted", "unsorted"):
        a, x0, t = tr[case]
        csr = CsrMatrix.from_dense(a)
        if case == "unsorted":
            csr = _shuffled_rows(csr, 43)
        apply, params, masks, resync = trainable_linear_sharded(csr, mesh)
        x = torch.from_numpy(x0).requires_grad_()
        y = apply(params, x)
        (y * torch.from_numpy(t)).sum().backward()
        arrays[f"{case}_y"] = y.detach().numpy()
        arrays[f"{case}_dx"] = x.grad.numpy()
        for k in ("vals", "vals_t"):
            arrays[f"{case}_d{k}"] = params[k].grad.numpy()
            arrays[f"{case}_mask_{k}"] = masks[k].numpy()
        with torch.no_grad():                  # one SGD step, then re-tie
            for v in params.values():
                v -= LR * v.grad
        resync(params)
        for k in ("vals", "vals_t"):
            arrays[f"{case}_{k}"] = params[k].detach().numpy()

    amgs = {}
    for name, (mat, b, kw, tol) in amg_operands().items():
        if name == "greedy":
            h = smoothed_aggregation(mat, mesh=mesh, device="cpu", **kw)
            lev = h.levels[0]
            rec["greedy_fmts"] = [lv.fmt for lv in h.levels]
            rec["greedy_shards"] = [o.n_shards for o in (lev.a, lev.p,
                                                         lev.pt)]
            try:
                h.save(os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                    "never.npz"))
            except ValueError as e:
                rec["greedy_save"] = str(e)
        else:
            h = smoothed_aggregation(mat, device="cpu", **kw).shard(mesh)
        amgs[name] = h
        rec[f"{name}_ops"] = [type(lv.a).__name__ for lv in h.levels]
        z, info = h.solve(torch.from_numpy(b), tol=tol)
        arrays[f"amg_{name}_z"] = z.numpy()
        rec[f"amg_{name}_iters"] = int(info["iters"])
    log = CollectiveLog()                      # level 0's halo apply
    v = torch.from_numpy(amg_operands()["grid"][1])
    with log.recording():
        amgs["grid"].levels[0].apply_a(v)
    rec["grid_l0_calls"] = log.calls
    odd = smoothed_aggregation(_lap2d(49), aggregation="grid",
                               device="cpu").shard(mesh)
    rec["odd_ops"] = [(lv.n, type(lv.a).__name__) for lv in odd.levels]

    sops = dryrun.solver_operands("small", ops)
    solved = dryrun.solver_cases(sops, mesh)
    rec["dryrun_levels"] = [solved.pop("grid_levels"),
                            solved.pop("greedy_levels")]
    rec["dryrun_drift"] = solved.pop("train_drift")
    arrays.update({f"dryrun_{k}": np.asarray(v) for k, v in solved.items()})

    rec["scaling"] = {name: [(p.devices, p.m, p.n, p.seconds, p.efficiency)
                             for p in sweep_scaling(verbose=False, reps=1,
                                                    **kw)]
                      for name, kw in SCALING.items()}

    co = comm_operands()
    calls = {}
    for p in ("n", "m", "ring"):
        calls[f"dense[{p}]"] = \
            lambda p=p: spmv_sharded(co["a1"], co["x1"], mesh, p)
        sp = SellMatrix.from_dense(co["a2"], device="cpu")
        calls[f"sell[{p}]"] = \
            lambda p=p, sp=sp: sell_spmm_sharded(sp, co["x2"], mesh, p)
    dias = {"stencil": (DiaMatrix.from_csr(co["stencil"], device="cpu"),
                        co["x4"]),
            "band": (DiaMatrix.from_dense(co["band"], device="cpu"),
                     co["x3"]),
            "sym": (DiaMatrix.from_dense(co["sym"], device="cpu"),
                    co["x3"])}
    for name, (dm, xd) in dias.items():
        calls[f"dia[halo] {name}"] = \
            lambda dm=dm, xd=xd: dia_spmm_sharded(dm, xd, mesh, "halo")
    apply, params, _, _ = trainable_linear_sharded(
        CsrMatrix.from_dense(co["a5"]), mesh)

    def train_step():
        x = torch.from_numpy(co["x5"]).requires_grad_()
        (apply(params, x) ** 2).sum().backward()

    calls["train"] = train_step
    for name, call in calls.items():
        call()                                 # shards upload first
        log = CollectiveLog()
        with log.recording():
            call()
        rec[f"comm:{name}"] = log.calls
    return arrays, rec


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start the 4 ranks (they run while the JAX calls do)."""
    out = str(tmp_path_factory.mktemp("world"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(r),
         str(WORLD), out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in range(WORLD)]
    # the dry-run program at 2 ranks, alongside (its own world and port)
    cli = subprocess.Popen(
        [sys.executable, "-m", "tpusparse_torch.parallel.dryrun", "--world",
         "2", "--size", "small", "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    scaling = subprocess.Popen(
        [sys.executable, "-m", "tpusparse_torch.bench.scaling", "--world",
         "2", "--device", "cpu", "--kernel", "sell", "--base-m", "256",
         "--base-n", "256", "--reps", "2"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield procs, out, cli, scaling
    for p in (*procs, cli, scaling):
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def world(spawned, jax_results):
    """The 4 ranks' results, {case: (rank, ...) array}."""
    procs, out = spawned[:2]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(WORLD)]
    return {k: np.stack([rk[k] for rk in ranks]) for k in ranks[0]}


@pytest.fixture(scope="module")
def small_ops():
    from tpusparse_torch.parallel import dryrun

    return dryrun.operands("small", WORLD)


@pytest.fixture(scope="module")
def jax_results(spawned):
    """The JAX package's sharded functions on the same operands, on a
    4-device mesh (and a 2 x 2 one) of the virtual CPU devices."""
    import jax

    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.formats.binned import BinnedSellMatrix
    from tpusparse.formats.dia import DiaMatrix
    from tpusparse.formats.rsell import rsell_shard_pack
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.parallel import make_mesh, spmv_sharded
    from tpusparse.parallel import sparse as jsp
    from tpusparse.testing import generators as jgen

    devs = jax.devices()[:WORLD]
    mesh = make_mesh({"n": WORLD}, devs)
    mesh2 = make_mesh({"b": 2, "n": WORLD // 2}, devs)
    m = 128 * WORLD
    a = jgen.random_sparse_matrix(m, m, density=0.5, seed=0)
    x = jgen.random_sparse_vector(m, density=0.5, seed=0)
    xb = jgen.random_sparse_batch(4, m, density=0.5, seed=1)
    out = {}
    for p in ("n", "m", "ring"):
        out[f"dense[{p}]"] = spmv_sharded(a, x, mesh=mesh, partition=p)
    s = SellMatrix.from_dense(a)
    for p in ("n", "m", "ring"):
        out[f"sell[{p}]"] = jsp.sell_spmm_sharded(s, x, mesh, p)
    out["sell[n ragged]"] = jsp.sell_spmm_sharded(
        SellMatrix.from_dense(a[:, :m - 128]), x, mesh, "n")
    for p in ("n", "m", "ring"):
        out[f"bsr[{p}]"] = jsp.bsr_spmm_sharded(
            jsp.bsr_shard_pack(a, WORLD, partition=p), x, mesh)
    aw = AwspMatrix.from_dense(a, g=1)
    for p in ("n", "m", "ring"):
        out[f"awsp[{p}]"] = jsp.awsp_spmm_sharded(aw, x, mesh, partition=p)
    out["binned[n]"] = jsp.binned_spmm_sharded(
        BinnedSellMatrix.from_dense(a), x, mesh)
    for asg in ("balance", "sorted"):
        out[f"rsell[{asg}]"] = jsp.rsell_spmm_sharded(
            rsell_shard_pack(a, WORLD, assignment=asg), x, mesh)
    out["tcsr[n]"] = jsp.tcsr_spmm_sharded(jsp.tcsr_shard_pack(a, WORLD),
                                           x, mesh)
    dias = {"laplace": (DiaMatrix.from_csr(jgen.stencil_csr((64, 64))),
                        jgen.random_sparse_vector(4096, 0.5, 0)),
            "stencil27": (DiaMatrix.from_csr(jgen.stencil_csr(
                (16, 16, 16), points=27)),
                jgen.random_sparse_vector(4096, 0.5, 0)),
            "band": (DiaMatrix.from_dense(np.tril(np.triu(a, -3), 5)), x)}
    for name, (dm, xd) in dias.items():
        for p in ("halo", "n"):
            out[f"dia[{p}] {name}"] = jsp.dia_spmm_sharded(dm, xd, mesh, p)
    out["sell[2d]"] = jsp.sell_spmm_sharded(s, xb, mesh2, "2d")
    out["bsr[2d]"] = jsp.bsr_spmm_sharded(jsp.bsr_shard_pack(a, WORLD // 2),
                                          xb, mesh2)
    return {k: np.asarray(v) for k, v in out.items()}


CASES = ["dense[n]", "dense[m]", "dense[ring]", "sell[n]", "sell[m]",
         "sell[ring]", "sell[n ragged]", "sell[2d]", "bsr[n]", "bsr[m]",
         "bsr[ring]", "bsr[2d]", "awsp[n]", "awsp[m]", "awsp[ring]",
         "binned[n]", "rsell[balance]", "rsell[sorted]", "tcsr[n]",
         "dia[halo] laplace", "dia[n] laplace", "dia[halo] stencil27",
         "dia[n] stencil27", "dia[halo] band", "dia[n] band"]


@pytest.mark.parametrize("case", CASES)
def test_world4_matches_jax_and_oracle(case, world, jax_results, small_ops):
    from tpusparse_torch.parallel import dryrun

    got = world[case]
    for r in range(1, WORLD):        # every rank holds the full y
        np.testing.assert_array_equal(got[r], got[0], err_msg=f"rank {r}")
    want = jax_results[case]
    assert got[0].shape == want.shape
    np.testing.assert_allclose(got[0], want, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(got[0], dryrun.oracle(small_ops, case),
                               rtol=0, atol=ATOL_ORACLE)


def test_world4_ran_every_case(world):
    assert sorted(world) == sorted(CASES)


def test_world4_halo_cases_ran_the_kernel_body(small_ops):
    """The two stencils at D = 4 (slabs of 1024 positions) take K8 with
    strips, as the JAX package takes its kernel there; the band and any
    batch take the shifted form."""
    from tpusparse_torch.formats import DiaMatrix
    from tpusparse_torch.parallel.sparse import dia_kernel_body

    for name, c in small_ops["stencils"].items():
        dm = DiaMatrix.from_csr(c, device="cpu")
        assert dia_kernel_body(dm, 1, WORLD), name
        assert not dia_kernel_body(dm, 2, WORLD), name
    band = DiaMatrix.from_dense(small_ops["band"], device="cpu")
    assert not dia_kernel_body(band, 1, WORLD)


def test_dryrun_program_world2(spawned, jax_results):
    """``python -m tpusparse_torch.parallel.dryrun --world 2``: 2 gloo
    ranks run the list; every case within 1e-3 of the oracle, the ranks
    agree bit for bit, the collectives are exact, and the halo CG takes
    the unsharded K8 CG's iterations and bits; the three solver cases hold
    to the unsharded builds (the grid's finest level through the halo
    partition, the greedy's as ragged-SELL shards)."""
    cli = spawned[2]
    out, err = cli.communicate(timeout=300)
    assert cli.returncode == 0, err[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["ok"] and rec["cases"] == len(CASES) + 3, rec
    assert rec["solver"]["ok"] and rec["solver_levels"] == {
        "grid_levels": ["_HaloDia", "Tensor"],
        "greedy_levels": ["rsell-shard", "dense"]}, rec
    assert rec["ranks_agree"] and rec["cg_same_bits"] and \
        rec["cg_iters"] == [rec["cg_unsharded_iters"]] * 2, rec
    assert rec["transport"] == "gloo" and rec["devices"] == ["cpu"] * 2


@pytest.fixture(scope="module")
def world1():
    """World size 1 in this process: gloo on the CPU."""
    import torch.distributed as dist

    from tpusparse_torch.parallel import initialize, make_mesh

    dev = initialize(device="cpu")
    yield dev, make_mesh({"n": 1}), make_mesh({"b": 1, "n": 1})
    dist.destroy_process_group()


def test_world1_in_process(world1, small_ops):
    """The whole list at world size 1: each result within 1e-3 of the
    oracle; ``initialize`` returns the live world again and refuses
    another."""
    from tpusparse_torch.parallel import dryrun, initialize

    dev, mesh, mesh2 = world1
    assert initialize(device="cpu") == dev
    with pytest.raises(RuntimeError, match="must be called once"):
        initialize(coordinator_address="127.0.0.1:9", num_processes=2,
                   process_id=0, device="cpu")
    got = dryrun.collectives(mesh)
    for name, want in dryrun.expected_collectives(1, 0).items():
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    packs = dryrun.host_packs(small_ops, 1, 1)
    calls = dryrun.sharded_calls(small_ops, packs, mesh, mesh2)
    assert sorted(calls) == sorted(CASES)
    for case, call in calls.items():
        y = call()
        assert y.device == dev
        np.testing.assert_allclose(y.numpy(), dryrun.oracle(small_ops, case),
                                   rtol=0, atol=ATOL_ORACLE, err_msg=case)


def _dense_calls(mesh) -> dict[str, np.ndarray]:
    """Dense ``spmv_sharded`` on the JAX fixture's operands, each partition
    from host (numpy) and from tensor operands; the two give the same
    bits."""
    import torch

    from tpusparse_torch.parallel import spmv_sharded
    from tpusparse_torch.testing import generators

    m = 128 * WORLD
    a = generators.random_sparse_matrix(m, m, density=0.5, seed=0)
    x = generators.random_sparse_vector(m, density=0.5, seed=0)
    out = {}
    for p in ("n", "m", "ring"):
        y_host = spmv_sharded(a, x, mesh, p)
        y = spmv_sharded(torch.from_numpy(a), torch.from_numpy(x), mesh, p)
        assert torch.equal(y, y_host), p
        out[f"dense[{p}]"] = y.numpy()
    return out


def _dense_worker(port: int, rank: int, world: int, out: str) -> int:
    import torch.distributed as dist

    from tpusparse_torch.parallel import initialize, make_mesh

    initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = _dense_calls(make_mesh({"n": world}))
    np.savez(os.path.join(out, f"dense{rank}.npz"), **res)
    dist.destroy_process_group()
    return 0


@pytest.fixture(scope="module")
def dense_world2(tmp_path_factory):
    """``_dense_calls`` on 2 gloo ranks (this file run as a script)."""
    out = str(tmp_path_factory.mktemp("dense"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "dense", str(port),
         str(r), "2", out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [dict(np.load(os.path.join(out, f"dense{r}.npz")))
            for r in range(2)]


@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_dense_sharded_from_host_and_tensors_matches_jax(
        partition, world1, dense_world2, jax_results):
    """Dense ``spmv_sharded`` at world 1 (this process) and on 2 gloo
    ranks, from host and from tensor operands (the same bits), within 1e-4
    of the JAX package's on its 4-device mesh; both ranks agree."""
    case = f"dense[{partition}]"
    want = np.asarray(jax_results[case])
    got1 = _dense_calls(world1[1])[case]
    np.testing.assert_allclose(got1, want, rtol=0, atol=ATOL_JAX)
    r0, r1 = (r[case] for r in dense_world2)
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_allclose(r0, want, rtol=0, atol=ATOL_JAX)


@pytest.mark.parametrize("partition", ["n", "m"])
def test_slabs_match_jax(partition):
    from tpusparse.parallel import launch as jlaunch
    from tpusparse_torch.parallel import launch

    m, n = 256, 512
    for i in range(4):
        kw = dict(partition=partition, process_index=i, process_count=4)
        assert launch.process_slab(m, n, **kw) == \
            jlaunch.process_slab(m, n, **kw)
        np.testing.assert_array_equal(
            launch.host_local_matrix(m, n, density=0.5, seed=11, **kw),
            jlaunch.host_local_matrix(m, n, density=0.5, seed=11, **kw))
    with pytest.raises(ValueError):
        launch.process_slab(100, 100, partition=partition, process_index=0,
                            process_count=3)


def test_initialize_needs_a_gpu_unless_asked_for_the_cpu():
    import torch

    from tpusparse_torch.parallel import initialize

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize(coordinator_address="127.0.0.1:9", num_processes=2,
                   process_id=0)


# -- the rest of the parallel layer: the world's ``_more`` ------------------


@pytest.fixture(scope="module")
def more(spawned, world):
    """Each rank's (arrays, record) from ``_more``."""
    out = spawned[1]
    return ([dict(np.load(os.path.join(out, f"more{r}.npz")))
             for r in range(WORLD)],
            [json.load(open(os.path.join(out, f"more{r}.json")))
             for r in range(WORLD)])


@pytest.fixture(scope="module")
def jax_train(spawned):
    """The JAX package's sharded training functions on the same operands,
    on 4 virtual devices (2 x 2 for ``2d``): y and the vjp of the target t,
    through ``jax.vjp``."""
    import jax
    import jax.numpy as jnp

    from tpusparse.autodiff import linear_map_sharded as jlms
    from tpusparse.autodiff import trainable_linear_sharded as jtls
    from tpusparse.formats.csr import CsrMatrix as JCsr
    from tpusparse.formats.sell import SellMatrix as JSell
    from tpusparse.parallel import make_mesh

    devs = jax.devices()[:WORLD]
    mesh = make_mesh({"n": WORLD}, devs)
    mesh2 = make_mesh({"b": 2, "n": WORLD // 2}, devs)
    tr = train_operands()
    out = {}
    a, xb, t = tr["lm"]
    c = JCsr.from_dense(a, use_native=False)
    s, s_t = JSell.from_csr(c), JSell.from_csr(c.transpose())
    for p in ("n", "m", "ring", "2d"):
        f = jlms(s, s_t, mesh2 if p == "2d" else mesh, p)
        y, vjp = jax.vjp(f, jnp.asarray(xb))
        out[f"lm_y[{p}]"], out[f"lm_dx[{p}]"] = y, vjp(jnp.asarray(t))[0]
    for case in ("sorted", "unsorted"):
        a, x0, t = tr[case]
        c = JCsr.from_dense(a, use_native=False)
        if case == "unsorted":
            c = _shuffled_rows(c, 43)
        apply, params, _, _ = jtls(c, mesh)
        y, vjp = jax.vjp(apply, params, jnp.asarray(x0))
        dp, dx = vjp(jnp.asarray(t))
        out[f"{case}_y"], out[f"{case}_dx"] = y, dx
        out[f"{case}_dvals"], out[f"{case}_dvals_t"] = \
            dp["vals"], dp["vals_t"]
    return {k: np.asarray(v) for k, v in out.items()}


def _replicated(arrays, key):
    """The array every rank holds whole: the same bits on every rank."""
    for r in range(1, WORLD):
        np.testing.assert_array_equal(arrays[r][key], arrays[0][key],
                                      err_msg=f"{key} on rank {r}")
    return arrays[0][key]


def _assembled(arrays, key, axis, size):
    """A sharded parameter (or its gradient) put back together: the ranks'
    shards joined along ``axis`` and cut to its unpadded ``size``."""
    full = np.concatenate([arrays[r][key] for r in range(WORLD)], axis=axis)
    return np.take(full, np.arange(size), axis=axis), full


@pytest.mark.parametrize("partition", ["n", "m", "ring", "2d"])
def test_sharded_linear_map_2d_and_bad_partition(partition, more,
                                                 jax_train):
    """``linear_map_sharded`` at world 4 (``2d`` on the 2 x 2 mesh): y and
    dx of sum(y * t) within 1e-4 of the JAX package's and 1e-5 of the
    port's unsharded ``linear_map``; an unknown partition is refused."""
    import torch

    from tpusparse_torch import SellMatrix, linear_map

    arrays, recs = more
    a, xb, t = train_operands()["lm"]
    y = _replicated(arrays, f"lm_y[{partition}]")
    dx = _replicated(arrays, f"lm_dx[{partition}]")
    np.testing.assert_allclose(y, jax_train[f"lm_y[{partition}]"], rtol=0,
                               atol=ATOL_JAX)
    np.testing.assert_allclose(dx, jax_train[f"lm_dx[{partition}]"],
                               rtol=0, atol=ATOL_JAX)
    f = linear_map(SellMatrix.from_dense(a, device="cpu"),
                   SellMatrix.from_dense(np.ascontiguousarray(a.T),
                                         device="cpu"))
    x = torch.from_numpy(xb).requires_grad_()
    y1 = f(x)
    (y1 * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(y, y1.detach().numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dx, x.grad.numpy(), rtol=0, atol=1e-5)
    assert all("partition" in rc["bad_partition"] for rc in recs)


def _check_trainable(case, more, jax_train):
    import torch

    from tpusparse_torch import trainable_linear
    from tpusparse_torch.autodiff import _TwinPack
    from tpusparse_torch.formats import CsrMatrix

    arrays, _ = more
    a, x0, t = train_operands()[case]
    csr = CsrMatrix.from_dense(a)
    apply, params, masks, _ = trainable_linear(csr, device="cpu")
    x = torch.from_numpy(x0).requires_grad_()
    y1 = apply(params, x)
    (y1 * torch.from_numpy(t)).sum().backward()
    one = {"y": y1.detach().numpy(), "dx": x.grad.numpy(),
           "dvals": params["vals"].grad.numpy(),
           "dvals_t": params["vals_t"].grad.numpy()}
    for k in ("y", "dx"):
        got = _replicated(arrays, f"{case}_{k}")
        np.testing.assert_allclose(got, jax_train[f"{case}_{k}"], rtol=0,
                                   atol=ATOL_JAX, err_msg=k)
        np.testing.assert_allclose(got, one[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    for k, axis in (("vals", 0), ("vals_t", 1)):
        size = params[k].shape[axis]
        got, full = _assembled(arrays, f"{case}_d{k}", axis, size)
        mask, mfull = _assembled(arrays, f"{case}_mask_{k}", axis, size)
        np.testing.assert_array_equal(mask, masks[k].numpy())
        assert not full[~mfull].any(), f"d{k}: a pad slot got a gradient"
        np.testing.assert_allclose(got, jax_train[f"{case}_d{k}"], rtol=0,
                                   atol=ATOL_JAX, err_msg=f"d{k}")
        np.testing.assert_allclose(got, one[f"d{k}"], rtol=0, atol=1e-5,
                                   err_msg=f"d{k}")
    # after one SGD step on each rank's shards, resync re-tied vals_t from
    # every rank's vals exactly (the unsharded re-tie map)
    vals, _ = _assembled(arrays, f"{case}_vals", 0, params["vals"].shape[0])
    vals_t, _ = _assembled(arrays, f"{case}_vals_t", 1,
                           params["vals_t"].shape[1])
    gather, live = _TwinPack(csr).retie_map()
    want = np.where(live, vals.ravel()[gather], 0).reshape(vals_t.shape)
    np.testing.assert_array_equal(vals_t, want)
    np.testing.assert_allclose(
        vals, params["vals"].detach().numpy()
        - LR * params["vals"].grad.numpy(), rtol=0, atol=1e-6)


def test_trainable_sharded_matches_single_chip(more, jax_train):
    """``trainable_linear_sharded`` at world 4 on the sorted CSR (one
    vector): y, dx, ``dvals`` and ``dvals_t`` (each rank's shards put
    together) within 1e-4 of the JAX package's sharded function and 1e-5
    of the port's ``trainable_linear``; pads get no gradient; the masks
    are the unsharded ones, cut; ``resync`` is exact."""
    _check_trainable("sorted", more, jax_train)


def test_trainable_sharded_unsorted_csr_grads(more, jax_train):
    """The same on a CSR whose rows are not sorted (3 batch rows; 9 column
    groups, padded to 12 over the 4 ranks): the constructor sorts before
    deriving its planes."""
    _check_trainable("unsorted", more, jax_train)


def _unsharded_solve(name):
    import torch

    from tpusparse_torch.amg import smoothed_aggregation

    mat, b, kw, tol = amg_operands()[name]
    z, info = smoothed_aggregation(mat, device="cpu", **kw).solve(
        torch.from_numpy(b), tol=tol)
    return z.numpy(), int(info["iters"])


def _relres(mat, z, b):
    from scipy import sparse as ssp

    sp = mat.astype(np.float64) if ssp.issparse(mat) else \
        mat.to_scipy().astype(np.float64)
    r = sp @ z.astype(np.float64) - b
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def test_sharded_grid_amg_matches_unsharded(more):
    """Grid AMG on the side-48 Laplacian placed with ``shard``: level 0
    through the halo partition, the unsharded build's CG iterations, z
    within 1e-5 of its z, the residual within 1e-3."""
    arrays, recs = more
    assert recs[0]["grid_ops"] == ["_HaloDia", "Tensor"]
    z = _replicated(arrays, "amg_grid_z")
    z0, iters0 = _unsharded_solve("grid")
    assert [rc["amg_grid_iters"] for rc in recs] == [iters0] * WORLD
    np.testing.assert_allclose(z, z0, rtol=0, atol=1e-5)
    mat, b = amg_operands()["grid"][:2]
    r = mat.to_scipy().astype(np.float64) @ z.astype(np.float64) - b
    assert np.abs(r).max() <= 1e-3


def test_sharded_vcycle_keeps_fine_level_halo_sharded(more):
    """Level 0's apply is the halo partition: ring shifts of the slab's
    edges only (two of x, one of the symmetric vals edge), then one gather
    of y's slab, never of x; a level whose n does not divide by D (side 49)
    stays unsharded."""
    _, recs = more
    n_loc = 48 * 48 // WORLD
    for rc in recs:
        kinds = [k for k, _ in rc["grid_l0_calls"]]
        assert kinds == ["ring_shift"] * 3 + ["all_gather_x"], kinds
        shifts = [b for k, b in rc["grid_l0_calls"] if k == "ring_shift"]
        assert max(shifts) <= 3 * 48 * 4 < n_loc * 4, shifts
        assert rc["grid_l0_calls"][-1][1] == (WORLD - 1) * n_loc * 4
        assert rc["odd_ops"][0] == [49 * 49, "DiaMatrix"]


def test_sharded_block_amg_1d_chain(more):
    """Block AMG on the 4096-node chain placed with ``shard``: the unsharded
    iterations, and a relative residual within max(2 x the unsharded one,
    1e-5) (the chain's conditioning caps fp32 CG near 2e-3)."""
    arrays, recs = more
    assert recs[0]["block_ops"][0] == "_HaloDia"
    z = _replicated(arrays, "amg_block_z")
    z0, iters0 = _unsharded_solve("block")
    assert [rc["amg_block_iters"] for rc in recs] == [iters0] * WORLD
    mat, b = amg_operands()["block"][:2]
    assert _relres(mat, z, b) <= max(2 * _relres(mat, z0, b), 1e-5)


def test_sharded_greedy_amg_unstructured(more):
    """``smoothed_aggregation(fem, dense_cutoff=512, mesh=mesh)`` on the
    2304-node Delaunay graph: level 0 as ragged-SELL shards (operator and
    both carriers, D shards each), the unsharded iterations, the residual
    rule, and ``save`` refused."""
    arrays, recs = more
    for rc in recs:
        assert rc["greedy_fmts"][0] == "rsell-shard", rc["greedy_fmts"]
        assert rc["greedy_shards"] == [WORLD] * 3
        assert "unsharded" in rc["greedy_save"]
    z = _replicated(arrays, "amg_greedy_z")
    z0, iters0 = _unsharded_solve("greedy")
    assert [rc["amg_greedy_iters"] for rc in recs] == [iters0] * WORLD
    mat, b = amg_operands()["greedy"][:2]
    assert _relres(mat, z, b) <= max(2 * _relres(mat, z0, b), 1e-5)


def test_world4_solver_cases(more, small_ops):
    """The dry run's three solver and training cases at world 4: the ranks
    agree, the grid and greedy solves take the unsharded iterations, and
    the train step's loss falls."""
    from tpusparse_torch.parallel import dryrun

    arrays, recs = more
    got = {k: _replicated(arrays, f"dryrun_{k}")
           for k in ("grid_z", "grid_iters", "greedy_z", "greedy_iters",
                     "train_loss", "train_x1")}
    sops = dryrun.solver_operands("small", small_ops)
    rec = dryrun.judge_solver(sops, got, dryrun.solver_reference(
        sops, "cpu"))
    assert rec["ok"], rec
    assert recs[0]["dryrun_levels"] == [["_HaloDia", "Tensor"],
                                        ["rsell-shard", "dense"]]


def _sweep(more, name):
    from tpusparse_torch.bench.scaling import ScalePoint

    recs = more[1]
    for rc in recs[1:]:              # every rank returns rank 0's points
        assert rc["scaling"][name] == recs[0]["scaling"][name]
    return [ScalePoint(*p) for p in recs[0]["scaling"][name]]


def test_weak_dense_n(more):
    pts = _sweep(more, "weak_dense_n")
    assert [p.devices for p in pts] == [1, 2, 4]
    assert pts[0].efficiency == 1.0
    assert all(p.seconds > 0 for p in pts)
    assert pts[-1].n == 256 * 4      # weak scaling grows the output dim


def test_strong_sell_m(more):
    pts = _sweep(more, "strong_sell_m")
    assert all(p.m == 512 and p.n == 256 for p in pts)
    assert pts[0].efficiency == 1.0


def test_ring_partition(more):
    assert len(_sweep(more, "weak_dense_ring")) == 2


def test_strong_baseline_not_device_one(more):
    """Efficiency is relative to the FIRST count."""
    pts = _sweep(more, "strong_dense_n_from_2")
    assert [p.devices for p in pts] == [2, 4]
    assert pts[0].efficiency == 1.0


def test_scaling_program_world2(spawned):
    """``python -m tpusparse_torch.bench.scaling --world 2``: one JSON line
    with a point at D = 1 and 2."""
    proc = spawned[3]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    assert [p["devices"] for p in rec["scaling"]] == [1, 2]
    assert rec["scaling"][0]["efficiency"] == 1.0


def _model_of(case):
    """``bench.commmodel``'s estimate for the world's ``case``, from the
    rank's slab of each operand at D = 4."""
    from tpusparse_torch.bench.commmodel import comm_model, train_model
    from tpusparse_torch.formats import DiaMatrix
    from tpusparse_torch.kernels import dia_spmv as dk
    from tpusparse_torch.parallel.sparse import dia_kernel_body

    d, n = WORLD, 1024
    if case == "train":
        return train_model(m=n, n=n // d, n_devices=d)
    part = case.split("[")[1].split("]")[0]
    if part in ("n", "ring"):
        return comm_model(part, m=n // d, n=n // d, n_devices=d)
    if part == "m":
        return comm_model(part, m=n // d, n=n, n_devices=d)
    co = comm_operands()
    name = case.split()[-1]
    dm = DiaMatrix.from_csr(co["stencil"], device="cpu")         if name == "stencil" else DiaMatrix.from_dense(co[name],
                                                       device="cpu")
    k, n_loc = len(dm.offsets), dm.shape[1] // d
    if dia_kernel_body(dm, 1, d):           # K8's strips
        hs = dk.halo_rows(dm.offsets, dm.sym) * 128
        return comm_model("halo", m=n_loc, n=n_loc, n_devices=d,
                          halo=(hs, hs), vals_halo=k * hs * dm.sym)
    dmin, dmax = min(dm.offsets), max(dm.offsets)
    if dm.sym:
        dmin = min(dmin, -dmax)
    return comm_model("halo", m=n_loc, n=n_loc, n_devices=d,
                      halo=(max(0, -dmin), max(0, dmax)),
                      vals_halo=k * dmax * dm.sym)


COMM_CASES = ["dense[n]", "dense[m]", "dense[ring]", "sell[n]", "sell[m]",
              "sell[ring]", "dia[halo] stencil", "dia[halo] band",
              "dia[halo] sym", "train"]


@pytest.mark.parametrize("case", COMM_CASES)
def test_commmodel_matches_recorded_collectives(case, more):
    """Every sharded call's collectives at world 4, as ``CollectiveLog``
    records them around ``parallel.comm``, are the model's: the same kinds
    in the same order and the same bytes received by each rank."""
    e = _model_of(case)
    for r, rc in enumerate(more[1]):
        calls = [tuple(c) for c in rc[f"comm:{case}"]]
        assert tuple(k for k, _ in calls) == e.collectives, (r, calls)
        assert sum(b for _, b in calls) == e.link_bytes, (r, calls)


def test_commmodel_cases_cover_both_halo_bodies():
    """The stencil's halo runs K8 with strips, the band and the symmetric
    matrix the shifted form (and the latter ships a vals edge)."""
    from tpusparse_torch.formats import DiaMatrix
    from tpusparse_torch.parallel.sparse import dia_kernel_body

    co = comm_operands()
    assert dia_kernel_body(DiaMatrix.from_csr(co["stencil"], device="cpu"),
                           1, WORLD)
    for name in ("band", "sym"):
        dm = DiaMatrix.from_dense(co[name], device="cpu")
        assert not dia_kernel_body(dm, 1, WORLD), name
    assert DiaMatrix.from_dense(co["sym"], device="cpu").sym


if __name__ == "__main__":
    if sys.argv[1] == "dense":
        sys.exit(_dense_worker(int(sys.argv[2]), int(sys.argv[3]),
                               int(sys.argv[4]), sys.argv[5]))
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                     sys.argv[4]))
