"""The yardstick's counts by hand at small sizes, and the device-built
HPCG operator against the port's own packer."""

import itertools

import numpy as np
import pytest
import torch

from benchmarks import harness
from benchmarks.plain import tf32

sg = harness.load_module("reference", "sgemv4096")
hp = harness.load_module("reference", "hpcg27")
hp_driver = harness.load_module("configs", "hpcg27")
HP_CFG = harness.load_json("configs", "hpcg27")


def test_product_bytes_count_touched_rows_only():
    a = torch.tensor([[1.0, 0.0, 2.0],      # row 0: 2 values
                      [0.0, 0.0, 0.0],      # row 1: none
                      [3.0, 4.0, 5.0],      # row 2: 3 values
                      [0.0, 6.0, 0.0]])     # row 3: 1 value
    pool = torch.tensor([[[1.0, 0.0, 0.0, 0.0],     # rows {0}
                          [0.0, 0.0, 0.0, 2.0]],    # rows {3}
                         [[0.0, 1.0, 1.0, 0.0],     # rows {1, 2}
                          [0.0, 0.0, 1.0, 0.0]]])   # rows {2}
    # X (B = 2, m = 4) read once and Y (2, n = 3) written once: 4 * 14 B
    assert sg.product_bytes(a, pool) == [4 * (2 + 1) + 56, 4 * 3 + 56]


def test_product_error_scales_by_the_terms():
    a = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    x = torch.tensor([[2.0, -2.0]])
    assert sg.product_error(a, x, torch.tensor([[0.0, 0.0]])) == 0.0
    # y[0] = 0 exactly from terms 2 and -2: a gap of 0.04 over |terms| 4
    assert sg.product_error(a, x, torch.tensor([[0.04, 0.0]])) == \
        pytest.approx(0.01)
    # nonzero where every term is zero, or not finite: infinite
    assert sg.product_error(a, x, torch.tensor([[0.0, 1e-30]])) == np.inf
    assert sg.product_error(a, x, torch.tensor([[np.nan, 0.0]])) == np.inf


def test_tf32_rounds_to_nearest_even_on_ten_bits():
    one = 1.0
    ulp = 2.0 ** -10
    t = torch.tensor([one + ulp / 4, one + 3 * ulp / 4, one + ulp / 2,
                      one + 3 * ulp / 2, -(one + 3 * ulp / 4), 26.0, -1.0],
                     dtype=torch.float32)
    assert tf32(t).tolist() == [one, one + ulp, one, one + 2 * ulp,
                                -(one + ulp), 26.0, -1.0]


def _stencil_csr(dims):
    """HPCG's operator as the port's CsrMatrix, built entry by entry."""
    from tpusparse_torch.formats.csr import CsrMatrix

    nx, ny, nz = dims
    rows, cols, vals = [], [], []
    for iz, iy, ix in itertools.product(range(nz), range(ny), range(nx)):
        r = ix + nx * (iy + ny * iz)
        for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3):
            jx, jy, jz = ix + dx, iy + dy, iz + dz
            if 0 <= jx < nx and 0 <= jy < ny and 0 <= jz < nz:
                rows.append(r)
                cols.append(jx + nx * (jy + ny * jz))
                vals.append(26.0 if (dx, dy, dz) == (0, 0, 0) else -1.0)
    n = nx * ny * nz
    return CsrMatrix.from_coo(n, n, np.array(rows), np.array(cols),
                              np.array(vals, dtype=np.float32))


def test_device_built_dia_equals_from_csr_bit_for_bit():
    from tpusparse_torch.formats.dia import DiaMatrix

    dims = (16, 16, 16)
    built = hp_driver.stencil_dia(HP_CFG, dims, torch.device("cpu"))
    packed = DiaMatrix.from_csr(_stencil_csr(dims), device="cpu")
    assert built.offsets == packed.offsets and built.sym and packed.sym
    assert built.shape == packed.shape and built.nnz == packed.nnz
    assert torch.equal(built.vals, packed.vals)


@pytest.mark.parametrize("dims", [(3, 4, 5), (6, 5, 4)])
def test_stencil_counts_and_apply(dims):
    csr = _stencil_csr(dims)
    n = hp.size(dims)
    assert csr.nnz == hp.nnz(dims)
    dense = np.zeros((n, n))
    r = np.repeat(np.arange(n), csr.row_nnz)
    dense[r, csr.col_idx] = csr.values
    # the stored upper triangle with its diagonal, counted once
    assert np.count_nonzero(np.triu(dense)) == (hp.nnz(dims) + n) // 2
    v = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, n))
    np.testing.assert_allclose(hp.apply(HP_CFG, v, dims).numpy(),
                               dense @ v.numpy(), rtol=0, atol=1e-12)


def test_residual_of_the_exact_solution_is_rounding():
    dims = (8, 8, 8)
    x = hp.rhs(5, 0, hp.size(dims), "cpu").double()
    b = hp.apply(HP_CFG, x, dims)
    assert hp.residual(HP_CFG, x, b, dims) < 1e-15
    assert hp.residual(HP_CFG, torch.zeros_like(x), b, dims) == 1.0
    assert hp.residual(HP_CFG, x * float("nan"), b, dims) == float("inf")
