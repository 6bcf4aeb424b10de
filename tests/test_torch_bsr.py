"""BSR and K6's plain version in the port against the JAX package.

- Packs are bit-identical: ``bi``, ``bj``, ``blocks``, ``shape``,
  ``padded``, ``block_m``, ``nnz`` and ``n_real``, from dense, from CSR and
  from blocks, for unaligned shapes, block_m of 64, 128 and 24, the zero
  blocks inserted for empty output groups, and the padding to 8 (from 64
  blocks) and to 32 (from 512).
- ``bsr_spmm_plain`` stays within 1e-4 of the JAX package's K6 in Pallas
  interpret mode on the same pack and inputs (the JAX kernel's split-bf16
  dot is ~4e-5 off fp32 at these sizes), and ``BsrMatrix`` within 1e-3 of
  the float64 oracle. The JAX calls cost about a second each, so they run
  three times in all, at <= 512 x 1024, in a module-scope fixture.
- The CUDA kernel's work plan (items of equal ``bj``, summed per group in
  item order) replayed in numpy gives the plain version's result.
"""

import numpy as np
import pytest
import torch

from tpusparse.formats.bsr import BsrMatrix as JBsr
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.kernels.bsr_spmv import bsr_spmm_padded
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch import from_reference_arrays
from tpusparse_torch.formats import BsrMatrix, CsrMatrix
from tpusparse_torch.formats.bsr import bsr_pack, bsr_pack_blocks, bsr_pack_csr
from tpusparse_torch.kernels.bsr_spmv import bsr_spmm, bsr_spmm_plain
from tpusparse_torch.kernels.rsell_spmv import work_plan

ATOL_JAX = 1e-4
ATOL_ORACLE = 1e-3

# name -> (matrix, block_m, stored blocks after canonicalization)
CASES = {
    "blockpruned": ("bp", 128, None),
    "unaligned": ("unaligned", 128, None),
    "block_m_64": ("bp", 64, None),
    "block_m_24": ("unaligned", 24, None),
    "empty_groups": ("gaps", 128, None),
    "pad_to_8": ("sparse", 32, 64),
    "pad_to_32": ("sparse_square", 8, 512),
}


def _matrix(kind):
    if kind == "bp":
        return jgen.block_pruned_matrix(512, 1024, keep_frac=0.3, fill=0.5,
                                        seed=3)
    if kind == "unaligned":
        return jgen.random_sparse_matrix(200, 300, density=0.3, seed=4,
                                         distribution="blocks", block=64)
    if kind == "gaps":             # output groups 1 and 3 hold no entry
        a = jgen.random_sparse_matrix(256, 512, density=0.2, seed=5)
        a[:, 128:256] = 0
        a[:, 384:] = 0
        return a
    if kind == "sparse_square":
        return jgen.random_sparse_matrix(1024, 1024, density=0.001, seed=6)
    return jgen.random_sparse_matrix(512, 1024, density=0.0005, seed=6)


def _csrs(a):
    jc = JCsr.from_dense(a, use_native=False)
    return CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values), jc


def _same(u, v, what):
    u, v = np.asarray(u), np.asarray(v)
    assert u.dtype == v.dtype and u.shape == v.shape, (what, u.dtype, v.dtype,
                                                       u.shape, v.shape)
    assert np.array_equal(u, v), what


def same_bsr(p, j):
    """Port numpy pack ``p`` against JAX ``BsrMatrix`` ``j``."""
    for k in ("bi", "bj", "blocks"):
        _same(p[k], getattr(j, k), k)
    for k in ("shape", "padded", "block_m", "nnz", "n_real"):
        assert tuple(np.atleast_1d(p[k])) == \
            tuple(np.atleast_1d(getattr(j, k))), k


@pytest.mark.parametrize("name", list(CASES))
def test_packs_match_jax(name):
    kind, block_m, stored = CASES[name]
    a = _matrix(kind)
    j = JBsr.from_dense(a, block_m=block_m)
    same_bsr(bsr_pack(a, block_m=block_m), j)
    same_bsr(bsr_pack(torch.from_numpy(a), block_m=block_m), j)
    tc, jc = _csrs(a)
    same_bsr(bsr_pack_csr(tc, block_m=block_m),
             JBsr.from_csr(jc, block_m=block_m))
    if stored is not None:
        assert j.bi.shape[0] % (32 if stored >= 512 else 8) == 0
        assert j.n_real >= stored and j.bi.shape[0] > j.n_real
    if kind == "gaps":
        assert set(np.asarray(j.bj).tolist()) == {0, 1, 2, 3}
        assert j.bi.shape[0] > j.n_real


def test_pack_from_blocks_and_duplicates_match_jax():
    rng = np.random.default_rng(7)
    bi = np.array([3, 0, 1, 0, 2])
    bj = np.array([2, 2, 0, 0, 1])
    blocks = rng.uniform(-1, 1, (5, 64, 128)).astype(np.float32)
    j = JBsr.from_blocks(250, 330, bi, bj, blocks)
    p = bsr_pack_blocks(250, 330, bi, bj, blocks)
    same_bsr(p, j)
    t = BsrMatrix.from_blocks(250, 330, bi, bj, blocks, device="cpu")
    assert torch.equal(t.blocks, torch.from_numpy(p["blocks"]))
    # duplicate COO positions sum in both packers
    c = CsrMatrix.from_coo(130, 200, np.array([0, 0, 129]),
                           np.array([5, 5, 199]),
                           np.array([1.0, 2.0, -1.0], np.float32))
    jc = JCsr(c.shape, c.row_ptr, c.col_idx, c.values)
    same_bsr(bsr_pack_csr(c), JBsr.from_csr(jc))
    assert BsrMatrix.from_csr(c, device="cpu").to_dense()[0, 5] == 3.0
    with pytest.raises(ValueError, match="block width"):
        bsr_pack_blocks(8, 8, [0], [0], np.zeros((1, 8, 64), np.float32))


@pytest.fixture(scope="module")
def jax_products():
    """The JAX package's K6 in interpret mode on three packs."""
    out = {}
    for kind, block_m, batch in [("bp", 128, 1), ("bp", 64, 3),
                                 ("unaligned", 24, 8)]:
        a = _matrix(kind)
        j = JBsr.from_dense(a, block_m=block_m)
        x = jgen.random_sparse_batch(batch, a.shape[0], 0.5, seed=11)
        xp = np.zeros((batch, j.padded[0]), np.float32)
        xp[:, :a.shape[0]] = x
        jy = np.asarray(bsr_spmm_padded(j.bi, j.bj, j.blocks, xp,
                                        block_m=block_m,
                                        n_padded=j.padded[1]))
        out[kind, block_m] = (a, x, jy[:batch, :a.shape[1]],
                              np.asarray(j.spmm(x)))
    return out


@pytest.mark.parametrize("kind,block_m", [("bp", 128), ("bp", 64),
                                          ("unaligned", 24)])
def test_plain_matches_jax_interpret(jax_products, kind, block_m):
    a, x, jy, jy_obj = jax_products[kind, block_m]
    t = BsrMatrix.from_dense(a, block_m=block_m, device="cpu")
    xt = torch.from_numpy(x)
    y = bsr_spmm_plain(t.bi, t.bj, t.blocks, xt, n_padded=t.padded[1],
                       n=a.shape[1])
    assert torch.equal(bsr_spmm(t.bi, t.bj, t.blocks, xt,
                                n_padded=t.padded[1], n=a.shape[1]), y)
    y_ref = reference.sgemm_cpu(x, a)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=ATOL_ORACLE)
    ty = t.spmm(x)
    assert torch.equal(ty, y) and ty.shape == jy_obj.shape
    np.testing.assert_allclose(ty.numpy(), jy_obj, rtol=0, atol=ATOL_JAX)
    y1 = t.spmv(x[0])
    assert y1.shape == (a.shape[1],)
    np.testing.assert_allclose(y1.numpy(), reference.sgemv_cpu(x[0], a),
                               rtol=0, atol=ATOL_ORACLE)


@pytest.mark.parametrize("name", ["blockpruned", "block_m_24", "pad_to_32"])
def test_round_trips(name):
    kind, block_m, _ = CASES[name]
    a = _matrix(kind)
    t = BsrMatrix.from_dense(a, block_m=block_m, device="cpu")
    assert np.array_equal(t.to_dense().numpy(), a)
    j = JBsr.from_dense(a, block_m=block_m)
    d = dict(kind="bsr", bi=np.asarray(j.bi), bj=np.asarray(j.bj),
             blocks=np.asarray(j.blocks), shape=j.shape, padded=j.padded,
             block_m=j.block_m, nnz=j.nnz, n_real=j.n_real)
    r = from_reference_arrays(d, device="cpu")
    assert isinstance(r, BsrMatrix) and repr(r) == repr(t)
    for kind in ("dia", "tcsr", "binned"):       # another kind's dict
        with pytest.raises(ValueError, match="lacks|unknown"):
            from_reference_arrays(dict(d, kind=kind), device="cpu")
    assert t.device_bytes() == j.device_bytes()
    assert t.block_density == pytest.approx(j.block_density)
    x = jgen.random_sparse_batch(2, a.shape[0], 0.5, seed=12)
    assert torch.equal(r.spmm(x), t.spmm(x))


def test_work_plan_replay_matches_plain():
    """The CUDA kernel's order of work, replayed in numpy: each item's
    blocks summed into a (B, 128) partial, each group's partials added in
    item order."""
    a = _matrix("sparse")
    t = BsrMatrix.from_dense(a, block_m=32, device="cpu")
    x = jgen.random_sparse_batch(3, 512, 0.5, seed=13)
    bi, bj = t.bi.numpy(), t.bj.numpy()
    blocks = t.blocks.numpy()
    nb = t.padded[1] // 128
    items, gptr = work_plan(bj, nb, per_item=5)
    part = np.zeros((len(items), 3, 128), np.float32)
    for i, (_, k0, k1) in enumerate(items):
        for k in range(k0, k1):
            part[i] += x[:, bi[k] * 32:(bi[k] + 1) * 32] @ blocks[k]
    y = np.stack([part[gptr[j]:gptr[j + 1]].sum(axis=0) for j in range(nb)],
                 axis=1).reshape(3, -1)
    plain = bsr_spmm_plain(t.bi, t.bj, t.blocks, torch.from_numpy(x),
                           n_padded=t.padded[1])
    np.testing.assert_allclose(y, plain.numpy(), rtol=0, atol=1e-5)


def test_empty_and_narrow_inputs():
    t = BsrMatrix.from_dense(np.zeros((256, 384), np.float32), device="cpu")
    assert t.n_real == 0 and t.bi.shape[0] == 3       # one zero per group
    y = t.spmv(np.ones(256, np.float32))
    assert y.shape == (384,) and torch.count_nonzero(y) == 0
    a = _matrix("unaligned")
    t = BsrMatrix.from_dense(a, device="cpu")
    x = jgen.random_sparse_batch(2, 200, 0.5, seed=14)
    x150 = np.where(np.arange(200) < 150, x, 0).astype(np.float32)
    narrow = t.spmm(torch.from_numpy(np.ascontiguousarray(x[:, :150])))
    np.testing.assert_allclose(narrow.numpy(), reference.sgemm_cpu(x150, a),
                               rtol=0, atol=ATOL_ORACLE)
    with pytest.raises(ValueError):
        t.spmm(np.zeros((1, t.padded[0] + 1), np.float32))
