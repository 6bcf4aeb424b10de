"""The routed experts' share of the bytes bound: the bytes the traced
slice's MoE layers need on their routed path (``reference/dsv2lite.py``
``layer_counts``: 4 B a stored value of G, U and D of every expert some
token routes to, by the float64 routing, h in and out, u in and y out
once) over the published HBM rate, against the device time of the
operations launched inside the program's ``tps.moe.experts`` spans (the
stacked G/U product, the SwiGLU, K3's plan and K3). The count does not
depend on the format or kernel the port picks, so no implementation can
read above 100%. A program without the span gives None."""

from benchmarks.peaks import share


def read(rec):
    s, c = rec["spans"].get("tps.moe.experts"), rec["counters"]
    if not s or not s["device_s"] or not c.get("moe_bytes") \
            or not rec["peaks"]:
        return None
    return share(c["moe_bytes"], s["device_s"], rec["peaks"]["hbm_Bps"],
                 "moe_roofline")
