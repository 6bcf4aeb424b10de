"""Device microseconds per CG iteration outside the operator: the device
time of the operations launched inside the ``solve`` spans but outside the
``spmv`` spans (the solver loop's vector operations and reductions), over
the iterations."""


def read(rec):
    sv, sp, c = rec["spans"].get("solve"), rec["spans"].get("spmv"), \
        rec["counters"]
    if not sv or not sp or not sv["device_s"] or not c.get("iters"):
        return None
    return (sv["device_s"] - sp["device_s"]) / c["iters"] * 1e6
