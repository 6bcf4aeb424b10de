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
  gloo ranks, started beside the world.

The JAX calls (Pallas interpret mode, two RSELL calls among them) run once
in a module-scoped fixture, the world once a file.
"""

from __future__ import annotations

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
    dist.destroy_process_group()
    return 0


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
    yield procs, out, cli
    for p in (*procs, cli):
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def world(spawned, jax_results):
    """The 4 ranks' results, {case: (rank, ...) array}."""
    procs, out, _ = spawned
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
    the unsharded K8 CG's iterations and bits."""
    import json

    cli = spawned[2]
    out, err = cli.communicate(timeout=300)
    assert cli.returncode == 0, err[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["ok"] and rec["cases"] == len(CASES), rec
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


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                     sys.argv[4]))
