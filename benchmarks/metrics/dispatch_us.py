"""Host microseconds per product: the mean host duration of the
``product`` spans, each around one call of the port's ``ops.spmv`` /
``ops.spmm``. Read under the profiler, which adds its own cost per host
operation."""


def read(rec):
    s = rec["spans"].get("product")
    if not s or not s["count"]:
        return None
    return s["cpu_s"] / s["count"] * 1e6
