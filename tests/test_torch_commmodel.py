"""``tpusparse_torch.bench.commmodel``: the link-traffic model of the
port's sharded calls, on the H100's published figures.

The model's formulas and its constants are checked here, and its
``CollectiveLog`` at world size 1 (this process, gloo on the CPU); that
each sharded call's recorded collectives at world size 4 are the model's,
kind by kind and byte for byte, is checked in the spawned world of
``tests/test_torch_parallel.py``
(``test_commmodel_matches_recorded_collectives``).
"""

import inspect

import numpy as np
import pytest

from tpusparse_torch.bench import commmodel
from tpusparse_torch.bench.commmodel import (CollectiveLog, comm_model,
                                             received_bytes, report,
                                             train_model)


def test_constants_are_the_h100s():
    assert commmodel.HBM_GBPS == 3350.0          # HBM3, H100 SXM
    assert commmodel.NVLINK_GBPS == 450.0        # NVLink 4, each way
    assert commmodel.LOWERING == {"sell": 1.009, "dia_halo": 1.700,
                                  "tcsr": 1.041}
    src = inspect.getsource(commmodel)
    for tpu in ("819", "v5e", "ICI_RING", "1.21"):
        assert tpu not in src, tpu


def test_received_bytes():
    assert [received_bytes(k, 4096, 1) for k in
            ("all_gather_x", "psum_y", "reduce_scatter_y", "ring_shift")] \
        == [0, 0, 0, 0]
    assert received_bytes("all_gather_x", 4096, 4) == 3 * 4096
    assert received_bytes("psum_y", 4096, 4) == 6144
    assert received_bytes("reduce_scatter_y", 4096, 4) == 3072
    assert received_bytes("ring_shift", 4096, 4) == 4096
    with pytest.raises(ValueError):
        received_bytes("broadcast", 4, 2)


def test_model_numbers():
    # n: the gather of y; m: a full-width all-reduce that does not shrink
    # with D; ring: D - 1 chunk shifts overlapped with the bands, then the
    # gather
    en = comm_model("n", m=4096, n=512, n_devices=8)
    assert en.collectives == ("all_gather_x",)
    assert en.link_bytes == 7 * 512 * 4
    assert 0.98 < en.efficiency < 1
    em = comm_model("m", m=512, n=4096, n_devices=8)
    assert em.collectives == ("psum_y",)
    assert em.link_bytes == int(2 * 7 / 8 * 4096 * 4)
    er = comm_model("ring", m=512, n=512, n_devices=8,
                    format_bytes=4096 * 512 * 4)
    assert er.collectives == ("ring_shift",) * 7 + ("all_gather_x",)
    assert er.link_bytes == 7 * 512 * 4 + 7 * 512 * 4
    assert er.efficiency > 0.95
    er_b = comm_model("ring", m=512, n=512, batch=512, n_devices=8,
                      format_bytes=4096 * 512 * 4)
    assert er_b.efficiency < er.efficiency       # batched: comm-bound
    eh = comm_model("halo", m=1024, n=1024, n_devices=4, halo=(5, 3),
                    vals_halo=0)
    assert eh.collectives == ("ring_shift", "ring_shift", "all_gather_x")
    assert eh.link_bytes == (5 + 3) * 4 + 3 * 1024 * 4
    eh1 = comm_model("halo", m=1024, n=1024, n_devices=4, halo=(0, 3),
                     vals_halo=3 * 3, lowering=commmodel.LOWERING["dia_halo"])
    assert eh1.collectives == ("ring_shift",) * 2 + ("all_gather_x",)
    assert eh1.compute_s == pytest.approx(1.7 * 1024 * 1024 * 4 / 3350e9)
    with pytest.raises(ValueError):
        comm_model("diagonal", m=8, n=8)


def test_train_model():
    e2 = train_model(m=4096, n=2048, n_devices=2, format_bytes=30_000_000)
    e16 = train_model(m=4096, n=256, n_devices=16, format_bytes=30_000_000)
    assert e2.collectives == ("all_gather_x", "psum_y")
    assert e2.link_bytes == 2048 * 4 + 4096 * 4
    # one small gather and all-reduce against 4 passes over the slab
    assert e2.efficiency > 0.99 and e16.efficiency > 0.99
    assert e16.link_bytes > e2.link_bytes


def test_report_renders():
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    txt = report(device_counts=(2, 8), card=card)
    assert "weak efficiency" in txt and "D=  8" in txt and card in txt
    assert "[halo]" in txt and "[train]" in txt
    assert "HBM3 3350 GB/s" in txt and "NVLink 4 450 GB/s" in txt


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    from tpusparse_torch.parallel import initialize, make_mesh

    initialize(device="cpu")
    yield make_mesh({"n": 1})
    dist.destroy_process_group()


def test_collective_log_at_world1(mesh):
    """At one rank every collective is recorded and moves nothing, as the
    model says; the log puts ``comm`` back as it was."""
    from tpusparse_torch import SellMatrix
    from tpusparse_torch.parallel import comm
    from tpusparse_torch.parallel.sparse import sell_spmm_sharded
    from tpusparse_torch.testing import generators

    a = generators.random_sparse_matrix(256, 256, density=0.5, seed=1)
    x = generators.random_sparse_vector(256, density=0.5, seed=1)
    s = SellMatrix.from_dense(a, device="cpu")
    real = comm.all_gather_x
    for p in ("n", "m", "ring"):
        log = CollectiveLog()
        with log.recording():
            y = sell_spmm_sharded(s, x, mesh, p)
        e = comm_model(p, m=256, n=256, n_devices=1)
        assert log.kinds == e.collectives and log.link_bytes == 0 \
            == e.link_bytes, (p, log.calls)
        np.testing.assert_allclose(y.numpy(), x @ a, rtol=0, atol=1e-4)
    assert comm.all_gather_x is real
