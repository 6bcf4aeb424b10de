"""RSELL and the permute plan in the port against the JAX package.

- Packs are bit-identical: ``cj``, ``ct``, ``idx``, ``vals``, ``run``,
  ``n_real``, ``w_max``, ``inv_perm`` and the ``(oidx, oh)`` plan, for
  sorted and unsorted, run-aligned and flat, empty and unaligned shapes;
  so are ``permute_plan`` (square and selecting) and ``csr_rows_subset``.
- The plain K4 + K5 through ``RsellMatrix`` stay within 1e-4 of the JAX
  package's Pallas kernels in interpret mode and within 1e-3 of the float64
  oracle. Those JAX calls cost seconds each, so they run four times in all,
  at <= 512 x 640, in module-scope fixtures.
- The CUDA kernel's work plan (items of equal ``cj``, summed per group in
  item order) is replayed in numpy and gives the plain version's result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.formats.csr import csr_rows_subset as jrows_subset
from tpusparse.formats.rsell import RsellMatrix as JRsell
from tpusparse.formats.rsell import _run_align as j_run_align
from tpusparse.formats.rsell import rsell_pack_csr as jpack
from tpusparse.kernels.permute import apply_permutation as japply
from tpusparse.kernels.permute import permute_plan as jplan
from tpusparse.kernels.rsell_spmv import wide_fits as jwide_fits
from tpusparse.testing import generators as jgen
from tpusparse.testing import reference
from tpusparse_torch.formats import CsrMatrix, RsellMatrix
from tpusparse_torch.formats.csr import csr_rows_subset
from tpusparse_torch.formats.rsell import _run_align, rsell_pack_csr
from tpusparse_torch.kernels.permute import (apply_permutation,
                                             permute_columns,
                                             permute_columns_plain,
                                             permute_plan, source_lanes)
from tpusparse_torch.kernels.rsell_spmv import (check_plan_ids, rsell_spmm,
                                                rsell_spmm_plain, wide_fits,
                                                work_plan)

ATOL_JAX = 1e-4
ATOL_ORACLE = 1e-3

# name -> (m, n, density, distribution, seed, sorted, run) as both packers
# give them
CASES = {
    "powerlaw": (512, 640, 0.2, "powerlaw", 1, True, 8),
    "flat": (256, 2048, 0.01, "uniform", 6, True, 1),
    "unsorted": (384, 256, 0.3, "uniform", 17, False, 8),
    "long_stream": (1536, 2048, 0.25, "uniform", 5, False, 8),
    "banded_unaligned": (200, 300, 0.1, "banded", 3, None, None),
    "blocks": (384, 256, 0.2, "blocks", 17, None, None),
    "one_column": (130, 1, 0.5, "uniform", 9, None, None),
}


def _matrix(name):
    m, n, d, dist, seed = CASES[name][:5]
    return jgen.random_sparse_matrix(m, n, density=d, seed=seed,
                                     distribution=dist)


def _same(u, v, what):
    u, v = np.asarray(u), np.asarray(v)
    assert u.dtype == v.dtype and u.shape == v.shape, (what, u.dtype, v.dtype,
                                                       u.shape, v.shape)
    assert np.array_equal(u, v), what


def _same_pack(p, q):
    for k in ("cj", "ct", "idx", "vals"):
        _same(p[k], q[k], k)
    for k in ("shape", "padded", "nnz", "n_real", "w_max", "run"):
        assert tuple(np.atleast_1d(p[k])) == tuple(np.atleast_1d(q[k])), k
    assert (p["inv_perm"] is None) == (q["inv_perm"] is None)
    if q["inv_perm"] is not None:
        _same(p["inv_perm"], q["inv_perm"], "inv_perm")
        _same(p["perm_plan"][0], q["perm_plan"][0], "oidx")
        _same(p["perm_plan"][1], q["perm_plan"][1], "oh")
    else:
        assert p["perm_plan"] is None


def _packs(a, sort="auto"):
    jc = JCsr.from_dense(a, use_native=False)
    tc = CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values)
    return rsell_pack_csr(tc, sort=sort), jpack(jc, sort=sort,
                                                use_native=False)


@pytest.mark.parametrize("name", list(CASES))
def test_pack_matches_jax(name):
    p, q = _packs(_matrix(name))
    _same_pack(p, q)
    want_sorted, want_run = CASES[name][5:]
    if want_sorted is not None:
        assert (p["inv_perm"] is not None) == want_sorted
        assert p["run"] == want_run
    if name == "long_stream":
        assert len(p["cj"]) >= 1024 and len(p["cj"]) % 128 == 0


@pytest.mark.parametrize("sort", [True, False])
def test_pack_forced_sort_matches_jax(sort):
    p, q = _packs(_matrix("banded_unaligned"), sort=sort)
    _same_pack(p, q)
    assert (p["inv_perm"] is not None) == sort


@pytest.mark.parametrize("shape", [(256, 256), (0, 128), (128, 0), (5, 7)])
def test_pack_empty_matches_jax(shape):
    p, q = _packs(np.zeros(shape, np.float32))
    _same_pack(p, q)
    assert p["n_real"] == 0 and p["cj"].shape == (1,)


def test_pack_from_csr_matches_jax():
    jc = jgen.random_sparse_csr(300, 700, density=0.05, seed=4,
                                distribution="powerlaw")
    tc = CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values)
    _same_pack(rsell_pack_csr(tc), jpack(jc, use_native=False))
    # rows whose entries are not sorted by m: the packer sorts them first
    rng = np.random.default_rng(0)
    perm = np.concatenate([s + rng.permutation(e - s) for s, e in
                           zip(jc.row_ptr[:-1], jc.row_ptr[1:])]).astype(int)
    jc2 = JCsr(jc.shape, jc.row_ptr, jc.col_idx[perm], jc.values[perm])
    tc2 = CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx[perm], jc.values[perm])
    _same_pack(rsell_pack_csr(tc2), jpack(jc2, use_native=False))


def test_matrix_matches_jax_metadata_and_dense():
    a = _matrix("powerlaw")
    j, t = JRsell.from_dense(a), RsellMatrix.from_dense(a, device="cpu")
    assert (t.shape, t.padded, t.nnz, t.n_real, t.w_max, t.run) == \
        (tuple(j.shape), tuple(j.padded), j.nnz, j.n_real, j.w_max, j.run)
    assert t.device_bytes() == j.device_bytes()
    for k in ("cj", "ct", "idx", "vals"):
        _same(getattr(t, k).numpy(), getattr(j, k), k)
    assert np.array_equal(t.to_dense().numpy(), a)
    assert np.array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
    assert t.perm_src.dtype == torch.int32 and t.perm_src.shape == (640,)
    assert "RsellMatrix" in repr(t)


@pytest.mark.parametrize("name", ["powerlaw", "unsorted", "flat"])
def test_read_bytes_counts_live_slots(name):
    """A product's byte bound reads the live slots and the chunk map, not
    the zero pads of each 8 x 128 chunk."""
    from tpusparse_torch.bench.roofline import format_bytes

    a = _matrix(name)
    t = RsellMatrix.from_dense(a, device="cpu")
    assert t.nnz == int((a != 0).sum())
    assert format_bytes(t) == t.read_bytes() == \
        t.nnz * 5 + t.cj.numel() * 8
    assert t.read_bytes() < t.device_bytes()


@pytest.mark.parametrize("seed,most", [(0, 3), (1, 20), (2, 9)])
def test_run_align_matches_jax_and_refuses_unsorted(seed, most):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, most, size=6)   # most=3: padding past the gate
    cj = np.repeat(np.arange(6, dtype=np.int32) * 2, counts)
    k = cj.size
    ct = rng.integers(0, 9, k).astype(np.int32)
    idx = rng.integers(0, 128, (k, 8, 128)).astype(np.int8)
    vals = rng.uniform(-1, 1, (k, 8, 128)).astype(np.float32)
    u, v = _run_align(cj, ct, idx, vals), j_run_align(cj, ct, idx, vals)
    assert (u is None) == (v is None)
    for uu, vv in zip(u or (), v or ()):
        _same(uu, vv, "run-aligned stream")
    with pytest.raises(ValueError, match="sorted"):
        _run_align(cj[::-1].copy(), ct, idx, vals)


@pytest.mark.parametrize("n,src_size", [(4096, None), (640, None),
                                        (129, None), (384, 1000),
                                        (200, 300)])
def test_permute_plan_matches_jax(n, src_size):
    rng = np.random.default_rng(n)
    perm_src = rng.permutation(src_size or n)[:n]
    p, q = permute_plan(perm_src, src_size), jplan(perm_src, src_size)
    assert p.keys() == q.keys()
    for k in p:
        _same(p[k], q[k], k)
    src = source_lanes(p["oidx"], p["oh"], n)
    assert src.dtype == np.int32 and np.array_equal(src, perm_src)
    tail = source_lanes(p["oidx"], p["oh"], p["np_"])[n:]
    assert (tail == -1).all()
    y = rng.uniform(-1, 1, (3, src_size or n)).astype(np.float32)
    out = apply_permutation(torch.from_numpy(y), (p["oidx"], p["oh"]), n)
    assert np.array_equal(out.numpy(), y[:, perm_src])


def test_permute_columns_matches_jax_kernel():
    rng = np.random.default_rng(7)
    perm_src = rng.permutation(640)
    p = jplan(perm_src)
    y = rng.uniform(-1, 1, (2, 640)).astype(np.float32)
    jy = np.asarray(japply(jnp.asarray(y), (jnp.asarray(p["oidx"]),
                                            jnp.asarray(p["oh"])), 640))
    src = torch.from_numpy(source_lanes(p["oidx"], p["oh"], 640))
    ty = permute_columns(torch.from_numpy(y), src)   # CPU -> plain
    assert np.array_equal(ty.numpy(), jy)
    # dead and out-of-range sources read 0
    bad = torch.tensor([-1, 0, 639, 640, 5000], dtype=torch.int32)
    out = permute_columns_plain(torch.from_numpy(y), bad)
    assert np.array_equal(out.numpy(), np.stack(
        [[0, r[0], r[639], 0, 0] for r in y]).astype(np.float32))


@pytest.mark.parametrize("rows", [np.arange(5), np.array([4, 0, 9, 2, 9]),
                                  np.array([3, 1, 12, 40])])
def test_csr_rows_subset_matches_jax(rows):
    jc = jgen.random_sparse_csr(50, 10, density=0.3, seed=2)
    tc = CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values)
    u, v = csr_rows_subset(tc, rows), jrows_subset(jc, rows)
    assert u.shape == v.shape
    for f in ("row_ptr", "col_idx", "values"):
        _same(getattr(u, f), getattr(v, f), f)


def test_wide_fits_is_the_jax_predicate():
    for m, n, b in [(8192, 8192, 1), (8192, 8192, 32), (65536, 65536, 4),
                    (65536, 65536, 48), (262144, 262144, 1), (100, 3, 7)]:
        assert wide_fits(m, n, b) == jwide_fits(m, n, b), (m, n, b)


def test_plan_id_guard():
    check_plan_ids(0xFFFF * 128, 0xFFFF * 128)
    for dims in [(0x10000 * 128, 128), (128, 0x10000 * 128)]:
        with pytest.raises(ValueError, match="16-bit"):
            check_plan_ids(*dims)
    one = torch.zeros(1, dtype=torch.int32)
    z = torch.zeros((1, 8, 128))
    with pytest.raises(ValueError, match="16-bit"):
        rsell_spmm_plain(one, one, z.to(torch.int8), z, torch.zeros(1, 128),
                         n_padded=0x10000 * 128)
    with pytest.raises(ValueError, match="16-bit"):
        rsell_spmm(one, one, z.to(torch.int8), z, torch.zeros(1, 128),
                   n_padded=0x10000 * 128)


def _replay_kernel(t, x, per_item):
    """The CUDA kernel's arithmetic order in numpy: one partial per work
    item, then each group's partials added in item order."""
    cj, ct = t.cj.numpy(), t.ct.numpy()
    idx, vals = t.idx.numpy().astype(np.int64), t.vals.numpy()
    nb = t.padded[1] // 128
    items, gptr = work_plan(cj, nb, per_item)
    xp = np.zeros((x.shape[0], t.padded[0]), np.float32)
    xp[:, :x.shape[1]] = x
    part = np.zeros((len(items), x.shape[0], 128), np.float64)
    for i, (j, c0, c1) in enumerate(items):
        assert (cj[c0:c1] == j).all() and 0 < c1 - c0 <= per_item
        for k in range(c0, c1):
            part[i] += (vals[k] * xp[:, ct[k] * 128 + idx[k]]).sum(axis=1)
    y = np.zeros((x.shape[0], nb * 128))
    for j in range(nb):
        y[:, j * 128:(j + 1) * 128] = part[gptr[j]:gptr[j + 1]].sum(axis=0)
    return y, items, gptr


@pytest.mark.parametrize("name", ["powerlaw", "flat", "unsorted",
                                  "long_stream"])
@pytest.mark.parametrize("per_item", [1, 3, 8])
def test_work_plan_replay_matches_plain(name, per_item):
    a = _matrix(name)
    t = RsellMatrix.from_dense(a, device="cpu")
    x = jgen.random_sparse_batch(2, a.shape[0], 0.5, seed=3)
    y, items, gptr = _replay_kernel(t, x, per_item)
    # every chunk, the zero tail included, belongs to exactly one item
    covered = np.zeros(len(t.cj), int)
    for _, c0, c1 in items:
        covered[c0:c1] += 1
    assert (covered == 1).all()
    assert (np.diff(items[:, 0]) >= 0).all() and gptr[-1] == len(items)
    plain = rsell_spmm_plain(t.cj, t.ct, t.idx, t.vals, torch.from_numpy(x),
                             n_padded=t.padded[1])
    np.testing.assert_allclose(y, plain.numpy(), rtol=0, atol=ATOL_JAX)


def test_work_plan_handles_unsorted_and_empty_streams():
    cj = np.array([2, 2, 0, 0, 0, 1, 0, 0], np.int32)
    items, gptr = work_plan(cj, 4, 2)
    assert items.tolist() == [[0, 2, 4], [0, 4, 5], [0, 6, 8], [1, 5, 6],
                              [2, 0, 2]]
    assert gptr.tolist() == [0, 3, 4, 5, 5]
    items, gptr = work_plan(np.zeros(0, np.int32), 3, 8)
    assert items.shape == (0, 3) and gptr.tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError):
        work_plan(np.array([3], np.int32), 3, 8)


def test_plain_reads_missing_columns_as_zero():
    a = _matrix("unsorted")
    t = RsellMatrix.from_dense(a, device="cpu")
    x = jgen.random_sparse_batch(3, 384, 0.5, seed=8)
    xp = np.zeros((3, t.padded[0]), np.float32)
    xp[:, :384] = x
    args = (t.cj, t.ct, t.idx, t.vals)
    narrow = rsell_spmm(*args, torch.from_numpy(x[:, :300]),
                        n_padded=t.padded[1], n=256)
    x300 = np.where(np.arange(384) < 300, x, 0).astype(np.float32)
    np.testing.assert_allclose(narrow.numpy(), reference.sgemm_cpu(x300, a),
                               rtol=0, atol=ATOL_ORACLE)
    full = rsell_spmm(*args, torch.from_numpy(xp), n_padded=t.padded[1])
    assert full.shape == (3, t.padded[1])
    np.testing.assert_allclose(full[:, :256].numpy(),
                               reference.sgemm_cpu(x, a), rtol=0,
                               atol=ATOL_ORACLE)
    with pytest.raises(ValueError):
        t.spmm(np.zeros((1, t.padded[0] + 1), np.float32))


@pytest.fixture(scope="module")
def jax_products():
    """The JAX package's RSELL products in interpret mode, four calls."""
    out = {}
    for name, batch in [("powerlaw", 1), ("powerlaw", 2), ("flat", 1),
                        ("unsorted", 1)]:
        a = _matrix(name)
        x = jgen.random_sparse_vector(a.shape[0], 0.5, seed=5) if batch == 1 \
            else jgen.random_sparse_batch(batch, a.shape[0], 0.5, seed=5)
        j = JRsell.from_dense(a)
        out[name, batch] = (a, x, np.asarray(j.spmv(x) if batch == 1
                                             else j.spmm(x)))
    return out


@pytest.mark.parametrize("name,batch", [("powerlaw", 1), ("powerlaw", 2),
                                        ("flat", 1), ("unsorted", 1)])
def test_plain_matches_jax_interpret(jax_products, name, batch):
    a, x, jy = jax_products[name, batch]
    t = RsellMatrix.from_dense(a, device="cpu")
    assert (t.perm_src is not None) == CASES[name][5]
    assert t.run == CASES[name][6]
    ty = t.spmv(x) if batch == 1 else t.spmm(x)
    ty_t = t.spmv(torch.from_numpy(x)) if batch == 1 \
        else t.spmm(torch.from_numpy(x))
    assert torch.equal(ty, ty_t) and ty.shape == jy.shape
    y_ref = reference.sgemv_cpu(x, a) if batch == 1 \
        else reference.sgemm_cpu(x, a)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(ty.numpy(), y_ref, rtol=0, atol=ATOL_ORACLE)
    np.testing.assert_allclose(jy, y_ref, rtol=0, atol=ATOL_ORACLE)


def test_empty_matrix_gives_zero():
    t = RsellMatrix.from_dense(np.zeros((256, 256), np.float32),
                               device="cpu")
    y = t.spmv(np.ones(256, np.float32))
    assert y.shape == (256,) and torch.count_nonzero(y) == 0
