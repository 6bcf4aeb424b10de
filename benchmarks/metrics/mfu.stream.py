"""The whole traced window's share of the chip's peak in the product
stream: the products' FLOPs (2 per nonzero and batch row) and their needed
bytes against the peaks. It bounds ``product_roofline`` from below
whatever kernel runs."""

from benchmarks.readers import step_mfu


def read(rec):
    return step_mfu(rec, "product", rec["counters"].get("product_bytes"),
                    "mfu.stream")
