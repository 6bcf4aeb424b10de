"""The products' share of the bytes bound: the bytes the traced slice's
products need (counted from the problem, ``reference`` of the config) over
the published HBM rate, against the device time of the operations launched
inside the ``product`` spans. The count does not depend on the format or
kernel the port picks, so no implementation can read above 100%."""

from benchmarks.peaks import share


def read(rec):
    s, c = rec["spans"].get("product"), rec["counters"]
    if not s or not s["device_s"] or not c.get("product_bytes") \
            or not rec["peaks"]:
        return None
    return share(c["product_bytes"], s["device_s"], rec["peaks"]["hbm_Bps"],
                 "product_roofline")
