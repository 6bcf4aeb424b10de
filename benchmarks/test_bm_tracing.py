"""The trace reduction on a hand-made trace: spans, device time launched
inside them, the busy union, and idle gaps named by the host's activity."""

import pytest

from benchmarks.tracing import Event, reduce


def test_reduce_attributes_by_launch_and_names_gaps():
    host = [
        Event("pass", 0.0, 10.0, 1, 7),
        Event("product", 1.0, 3.0, 2, 7),
        Event("cudaLaunchKernel", 1.5, 1.6, 3, 7),
        Event("product", 4.0, 5.0, 4, 7),
        Event("aten::zeros", 4.1, 4.5, 5, 7),
        Event("cudaStreamSynchronize", 6.0, 10.0, 6, 7),
        Event("other_thread", 0.0, 10.0, 9, 8),
    ]
    dev = [
        Event("k1", 2.0, 4.0, 3),       # its runtime launch: first product
        Event("fill", 4.6, 5.5, 77, link=5),   # linked to an op: second
        Event("k2", 5.0, 7.0, 0),       # no launch found: busy, unattributed
    ]
    rec = reduce(host, dev, ("pass", "product"))
    assert rec["window_s"] == 10.0
    assert rec["busy_s"] == pytest.approx(2.0 + 2.4)     # [2,4] + [4.6,7]
    assert rec["spans"]["product"] == {"count": 2, "cpu_s": 3.0,
                                       "device_s": pytest.approx(2.9)}
    assert rec["spans"]["pass"]["device_s"] == pytest.approx(2.9)
    assert rec["attributed_s"] == pytest.approx(2.9)
    gaps = dict(rec["breakdown"]["idle_gaps"])
    # [0,2] mid 1.0 in the first product; [4,4.6] mid 4.3 in aten::zeros; [7,10] mid 8.5
    # in the synchronisation
    assert gaps == {"product": pytest.approx(2.0),
                    "aten::zeros": pytest.approx(0.6),
                    "cudaStreamSynchronize": pytest.approx(3.0)}
    ops = dict(rec["breakdown"]["device_ops"])
    assert ops == {"k1": 2.0, "k2": 2.0, "fill": pytest.approx(0.9)}


def test_reduce_needs_a_span():
    with pytest.raises(ValueError):
        reduce([Event("x", 0.0, 1.0)], [], ("pass",))
