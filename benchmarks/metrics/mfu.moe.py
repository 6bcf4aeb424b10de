"""The whole traced window's share of the chip's peak in the FFN stack:
the steps' FLOPs (2 per stored value and token that uses it) and their
needed bytes (``reference/dsv2lite.py`` ``layer_counts``: the live
experts', the shared experts', the dense layer's and the router's stored
values, h, x and y once) against the peaks."""

from benchmarks.readers import step_mfu


def read(rec):
    return step_mfu(rec, "tps.moe", rec["counters"].get("step_bytes"),
                    "mfu.moe")
