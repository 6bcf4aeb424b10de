"""The port's entry point (``tpusparse_torch/entry.py``) against
``__graft_entry__.entry``: the same SELL pack bit for bit, and ``fn(*args)``
within 1e-4 of the float64 oracle."""

import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jentry
from tpusparse.formats import io as jio

from tpusparse_torch.entry import entry
from tpusparse_torch.formats import io as tio


def test_entry_matches_the_jax_entry():
    fn, (pack, x) = entry(device="cpu")
    _, (jpack, jx) = jentry()
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    jk, jaux, jdt, jarr = jio.encode(jpack)
    tk, taux, tdt, tarr = tio.encode(pack)
    assert (jk, jaux, jdt) == (tk, taux, tdt)
    for a, b in zip(jarr, tarr, strict=True):
        assert a.tobytes() == b.tobytes()
    y = fn(pack, x)
    a = pack.to_dense().double().numpy()
    ref = x.double().numpy() @ a
    assert y.shape == (1024,) and y.dtype == torch.float32
    np.testing.assert_allclose(y.double().numpy(), ref, atol=1e-4)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
