"""The whole traced window's share of the chip's peak in the solver cells:
the operator FLOPs and the bytes of the applications (needed bytes) and of
the iterations' vector passes (x, r and p read and written, Ap read)
against the peaks."""

from benchmarks.readers import step_mfu


def read(rec):
    c = rec["counters"]
    need = c.get("spmv_bytes") and c["spmv_bytes"] + c["vector_bytes"]
    return step_mfu(rec, "solve", need, "mfu.solve")
