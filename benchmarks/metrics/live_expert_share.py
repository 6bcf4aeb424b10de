"""The share of the routed experts that K3 read: the program's counters
``moe.live_groups`` (the live groups, one an expert, of the device plans
of the traced slice's MoE layer calls) over ``moe.experts`` times
``moe.calls``. Counted on the device, read once after the slice. A program
without the counters gives None."""


def read(rec):
    c = rec["counters"]
    if not c.get("moe.calls") or "moe.live_groups" not in c:
        return None
    return c["moe.live_groups"] / (c["moe.experts"] * c["moe.calls"])
