"""Bodies that several per-layer readers share: each metric keeps its own
file under ``metrics/`` and calls one of these with what sets it apart."""

from benchmarks.peaks import share


def idle_share(rec, span: str):
    """1 - (the union of the device operations' intervals) / (the traced
    window), in a cell whose slice has ``span`` spans."""
    if span not in rec["spans"] or not rec["busy_s"]:
        return None
    return 1.0 - rec["busy_s"] / rec["window_s"]


def step_mfu(rec, span: str, need_bytes, what: str):
    """The traced window's share of the chip's peak: the least time the
    slice's work needs, the larger of its FLOPs over the float32 peak and
    ``need_bytes`` over the HBM peak, against the window's length."""
    c, p = rec["counters"], rec["peaks"]
    if span not in rec["spans"] or not need_bytes or not p:
        return None
    least = max(c["flops"] / p["fp32_flops"], need_bytes / p["hbm_Bps"])
    return share(least, rec["window_s"], 1.0, what)
