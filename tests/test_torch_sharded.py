"""The sharded training and AMG entry points at world size 1, in this
process (gloo on the CPU), and ``_ShardedOp``'s packs against the JAX
package's.

- At one rank the sharded paths run the same kernels on the same planes as
  the unsharded ones: ``trainable_linear_sharded`` gives
  ``trainable_linear``'s y, dx, ``dvals`` and ``dvals_t`` bit for bit, and
  ``resync`` re-ties exactly; a grid hierarchy placed with ``shard`` solves
  in the unsharded iterations and bits; ``smoothed_aggregation(mesh=...)``
  packs its greedy levels as ragged-SELL shards and keeps the unsharded
  iteration count.
- ``_ShardedOp``'s contiguous ragged-SELL packs of a greedy level (A, P and
  Pᵀ of the 2304-node Delaunay graph) are the JAX package's
  ``rsell_shard_pack(..., "contiguous")`` bit for bit at D = 4 and through
  ``_ShardedOp.from_scipy`` at D = 1 (host packing only: no JAX RSELL
  product runs).
- The refusals: an unknown partition, a mismatched transpose, a greedy
  hierarchy packed for one device (``shard``), saving a sharded hierarchy.
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import (SellMatrix, linear_map_sharded,
                             trainable_linear, trainable_linear_sharded)
from tpusparse_torch.amg import _ShardedOp, host_hierarchy, \
    smoothed_aggregation
from tpusparse_torch.formats import CsrMatrix
from tpusparse_torch.testing import generators


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    from tpusparse_torch.parallel import initialize, make_mesh

    initialize(device="cpu")
    yield make_mesh({"n": 1})
    dist.destroy_process_group()


@pytest.mark.parametrize("batch", [0, 3])
def test_world1_trainable_sharded_is_unsharded_bits(mesh, batch):
    a = generators.random_sparse_matrix(384, 640, density=0.25, seed=51)
    csr = CsrMatrix.from_dense(a)
    ap, p, masks, resync = trainable_linear_sharded(csr, mesh)
    a1, p1, masks1, _ = trainable_linear(csr, device="cpu")
    x0 = generators.random_sparse_vector(384, 0.5, 52) if batch == 0 else \
        generators.random_sparse_batch(batch, 384, 0.5, 52)
    t = torch.from_numpy(np.random.default_rng(53).uniform(
        -1, 1, x0.shape[:-1] + (640,)).astype(np.float32))
    x, x1 = (torch.from_numpy(x0).requires_grad_() for _ in range(2))
    y, y1 = ap(p, x), a1(p1, x1)
    assert torch.equal(y, y1)
    (y * t).sum().backward()
    (y1 * t).sum().backward()
    assert torch.equal(x.grad, x1.grad)
    for k in p:
        assert torch.equal(p[k].grad, p1[k].grad), k
        assert torch.equal(masks[k], masks1[k]), k
        assert not p[k].grad[~masks[k]].any(), k
    for k, v in ap.statics.items():
        assert torch.equal(v, a1.statics[k]), k
    with torch.no_grad():
        for v in (*p.values(), *p1.values()):
            v -= 1e-2 * v.grad
    resync(p)
    assert torch.equal(p["vals_t"], p1["vals_t"])


def test_world1_linear_map_sharded_refusals(mesh):
    a = generators.random_sparse_matrix(256, 384, density=0.3, seed=54)
    s = SellMatrix.from_dense(a, device="cpu")
    s_t = SellMatrix.from_dense(np.ascontiguousarray(a.T), device="cpu")
    with pytest.raises(ValueError, match="partition"):
        linear_map_sharded(s, s_t, mesh, "diagonal")
    with pytest.raises(ValueError, match="transpose"):
        linear_map_sharded(s, s, mesh)
    x = torch.from_numpy(generators.random_sparse_vector(256, 0.5, 55)) \
        .requires_grad_()
    linear_map_sharded(s, s_t, mesh, "n")(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), a.sum(axis=1), rtol=0,
                               atol=1e-4)


def test_sharded_entry_points_take_the_card_unless_asked(mesh):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    csr = CsrMatrix.from_dense(generators.random_sparse_matrix(
        128, 128, density=0.3, seed=56))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainable_linear_sharded(csr, mesh, device="cuda")
    ap, p, _, _ = trainable_linear_sharded(csr, mesh)      # the mesh's CPU
    assert p["vals"].device.type == "cpu"


def test_world1_grid_amg_shard_is_unsharded_bits(mesh):
    lap = generators.stencil_csr((40, 40))
    amg = smoothed_aggregation(lap, aggregation="grid", device="cpu",
                               dense_cutoff=256)
    sh = amg.shard(mesh)
    assert type(sh.levels[0].a).__name__ == "_HaloDia"
    assert sh.mesh is mesh and amg.mesh is None
    b = torch.from_numpy(np.random.default_rng(57).normal(size=1600)
                         .astype(np.float32))
    z, info = sh.solve(b, tol=1e-5)
    z0, info0 = amg.solve(b, tol=1e-5)
    assert info["iters"] == info0["iters"]
    assert torch.equal(z, z0)
    again = sh.shard(mesh)                    # placed levels pass through
    assert [lv.a for lv in again.levels] == [lv.a for lv in sh.levels]
    with pytest.raises(ValueError, match="unsharded"):
        sh.save("never.npz")


def test_sharded_amg_rejects_packed_carriers(mesh):
    amg = smoothed_aggregation(generators.stencil_csr((64, 64)),
                               device="cpu")
    assert amg.levels[0].kind == "packed"
    with pytest.raises(ValueError, match="grid"):
        amg.shard(mesh)


def test_world1_greedy_mesh_build(mesh, tmp_path):
    c = generators.mesh_csr(32, 32, seed=4)
    sh = smoothed_aggregation(c, dense_cutoff=256, mesh=mesh)
    h0 = smoothed_aggregation(c, dense_cutoff=256, device="cpu")
    fmts = [lv.fmt for lv in sh.levels]
    assert fmts[0] == "rsell-shard" and fmts[-1] == "dense", fmts
    lev = sh.levels[0]
    assert [o.n_shards for o in (lev.a, lev.p, lev.pt)] == [1, 1, 1]
    assert lev.a.device_bytes() == sum(
        np.asarray(getattr(lev.a.shards, k)).nbytes
        for k in ("cj", "ct", "idx", "vals"))
    b = torch.from_numpy(np.random.default_rng(58).uniform(-1, 1, c.shape[0])
                         .astype(np.float32))
    z, info = sh.solve(b, tol=1e-6)
    z0, info0 = h0.solve(b, tol=1e-6)
    assert info["iters"] == info0["iters"]
    sp = c.to_scipy().astype(np.float64)

    def relres(zz):
        return np.linalg.norm(sp @ zz.numpy().astype(np.float64) - b.numpy()) \
            / np.linalg.norm(b.numpy())

    assert relres(z) <= max(2 * relres(z0), 1e-5)
    with pytest.raises(ValueError, match="unsharded"):
        sh.save(tmp_path / "never.npz")
    h0.save(tmp_path / "fine.npz")                 # the unsharded build


def _level0_mats():
    levels, _, _ = host_hierarchy(generators.mesh_csr(48, 48, seed=4))
    h = levels[0]
    assert h.kind == "packed"
    return {"A": h.sp, "P": h.p, "Pt": h.p.T.tocsr()}


@pytest.mark.parametrize("which", ["A", "P", "Pt"])
def test_sharded_op_packs_match_jax(mesh, which):
    from tpusparse.formats.csr import CsrMatrix as JCsr
    from tpusparse.formats.rsell import rsell_shard_pack as jpack
    from tpusparse_torch.formats.rsell import rsell_shard_pack

    sp = _level0_mats()[which].astype(np.float32)
    for d in (4, 1):
        want = jpack(JCsr.from_scipy(sp), d, assignment="contiguous")
        got = _ShardedOp.from_scipy(sp, mesh).shards if d == 1 else \
            rsell_shard_pack(CsrMatrix.from_scipy(sp), d,
                             assignment="contiguous")
        for k in ("cj", "ct", "idx", "vals", "group_map"):
            np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                          np.asarray(getattr(want, k)),
                                          err_msg=f"{which} D={d} {k}")
        assert got.perm_plan is None and want.perm_plan is None
        assert (tuple(got.shape), tuple(got.padded), int(got.nnz)) == \
            (tuple(want.shape), tuple(want.padded), int(want.nnz))
