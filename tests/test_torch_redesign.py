"""What the redesigned K2 (``csrc/dense.cu``) and K11
(``csrc/sell_mxu_spmm.cu``) rest on, checked on the CPU with numpy alone
(no kernel runs here):

- K11's products in 3xTF32 (each operand split into a TF32 ``hi`` rounded
  to nearest, ties away, and a TF32 ``lo`` of the rest; hi*hi + hi*lo +
  lo*hi summed in fp32) stay within 1e-4 of the float64 oracle at
  2048^2, d = 0.5, B = 8, while single-pass TF32 is more than 1e-3 off:
  the reason the kernel never multiplies in one pass;
- the launch shapes of K2 and K11 (``dense_shape``, ``mxu_shape``): the
  slices cover every row or window exactly once, fill the card in one wave,
  and the arrival counters of the fused reduce number the column groups x
  the batch tiles.
"""

import numpy as np
import pytest

from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.dense import STAGE_ROWS, dense_shape
from tpusparse_torch.kernels.sell_mxu_spmm import batch_tile, mxu_shape
from tpusparse_torch.testing import generators
from tpusparse_torch.utils import cdiv

H100_SMS = 132


def tf32(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: fp32 rounded to 10 mantissa bits, ties away from
    zero (the low 13 bits cleared)."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def window_products(x, a, terms):
    """y = sum over 128-row windows of sum over ``terms`` of xs @ as, each
    product in fp32 (TF32 x TF32 products are exact in fp32) and added to
    one fp32 accumulator, window by window, as the kernel's mma.sync
    steps do."""
    y = np.zeros((x.shape[0], a.shape[1]), np.float32)
    for t in range(0, a.shape[0], 128):
        for xs, as_ in terms:
            y += xs[:, t:t + 128] @ as_[t:t + 128]
    return y


@pytest.fixture(scope="module")
def floors_like():
    a = generators.random_sparse_matrix(2048, 2048, density=0.5, seed=0)
    x = generators.random_sparse_batch(8, 2048, 0.5, seed=0)
    return x, a, x.astype(np.float64) @ a.astype(np.float64)


def veltkamp(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The CUDA kernel's split (csrc/sell_mxu_spmm.cu:split_tf32): hi by
    Veltkamp's split with 2^13 + 1 in fp32, lo = v - hi as the tensor core
    reads it (its low 13 bits ignored)."""
    v = np.asarray(v, dtype=np.float32)
    c = v * np.float32(8193.0)
    hi = c - (c - v)
    lo = (v - hi).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


def rna_split(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """hi = cvt.rna.tf32.f32(v), lo = cvt.rna.tf32.f32(v - hi)."""
    hi = tf32(v)
    return hi, tf32(v - hi)


@pytest.mark.parametrize("split", [rna_split, veltkamp])
def test_3xtf32_meets_the_contract(floors_like, split):
    x, a, want = floors_like
    (ah, al), (xh, xl) = split(a), split(x)
    for hi, v in ((ah, a), (xh, x)):       # hi is a TF32 value, and nearest
        assert not (hi.view(np.uint32) & 0x1FFF).any()
        assert (np.abs(v - hi) <= np.abs(v - tf32(v)) * (1 + 1e-6)).all()
    y = window_products(x, a, [(xl, ah), (xh, al), (xh, ah)])
    err = float(np.abs(y - want).max())
    assert err <= 1e-4, err


def test_single_pass_tf32_breaks_the_contract(floors_like):
    x, a, want = floors_like
    y = window_products(x, a, [(tf32(x), tf32(a))])
    assert float(np.abs(y - want).max()) > 1e-3


def _covers(units, per, slices):
    seen = np.zeros(units, np.int64)
    for k in range(slices):
        lo, hi = k * per, min(units, (k + 1) * per)
        assert lo < hi, (k, per, slices)     # no empty slice
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("sms", [H100_SMS, 114, 1])
@pytest.mark.parametrize("m,n,batch", [(4096, 4096, 1), (4096, 4096, 8),
                                       (4099, 4096, 3), (37, 4096, 8),
                                       (130, 301, 5), (1, 100, 2),
                                       (100000, 128, 1), (4096, 4096, 20)])
def test_dense_shape_covers_every_row_once(m, n, batch, sms):
    per, slices, counters = dense_shape(m, n, batch, sms)
    assert per % STAGE_ROWS == 0
    _covers(m, per, slices)
    bt = 1 if batch <= 1 else 2 if batch == 2 else 4 if batch <= 4 else 8
    groups = cdiv(n, 128) * cdiv(batch, bt)
    assert counters == groups
    resident = {1: 8, 2: 8, 4: 6, 8: 4}[bt]
    if groups <= resident * sms:             # one wave of resident blocks
        assert groups * slices <= resident * sms


@pytest.mark.parametrize("sms", [H100_SMS, 114, 1])
@pytest.mark.parametrize("nb,nt,batch", [(32, 32, 1), (32, 32, 8),
                                         (32, 32, 32), (32, 32, 40),
                                         (3, 2, 5), (1, 1, 1), (64, 64, 16),
                                         (200, 7, 1)])
def test_mxu_shape_covers_every_window_once(nb, nt, batch, sms):
    per, slices, counters = mxu_shape(nb, nt, batch, sms)
    _covers(nt, per, slices)
    assert batch_tile(batch) in (8, 16, 32)
    assert counters == nb * cdiv(batch, batch_tile(batch))
    if counters <= sms:                      # one block an SM at most
        assert counters * slices <= sms


def test_mxu_shape_gives_blocks_several_tiles():
    """At the floors study's shape each of the 4096^2 pack's 32 groups is
    cut into 4 runs of 8 windows: 128 blocks on the H100's 132 SMs."""
    assert mxu_shape(32, 32, 8, H100_SMS) == (8, 4, 32)
    assert mxu_shape(32, 32, 40, H100_SMS) == (16, 2, 64)


@pytest.mark.parametrize("units", [0, 1, 5, 16, 17])
def test_launch_shape_small_units(units):
    """Fewer units than slots: one quantum a slice, and never no slice."""
    per, slices = _build.launch_shape(units, 4, 100, quantum=16)
    assert per == 16 and slices == max(1, cdiv(units, 16))
