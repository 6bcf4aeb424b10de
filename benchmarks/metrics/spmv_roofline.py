"""The operator applications' share of the bytes bound: the bytes the
traced slice's applications need (the stored upper triangle with the
diagonal, 4 B a value, x read and y written once) over the published HBM
rate, against the device time of the operations launched inside the
``spmv`` spans."""

from benchmarks.peaks import share


def read(rec):
    s, c = rec["spans"].get("spmv"), rec["counters"]
    if not s or not s["device_s"] or not c.get("spmv_bytes") \
            or not rec["peaks"]:
        return None
    return share(c["spmv_bytes"], s["device_s"], rec["peaks"]["hbm_Bps"],
                 "spmv_roofline")
