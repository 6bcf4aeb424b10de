"""CG iterations per solve: the mean, over the traced slice's solves, of
the iteration count that the port's ``cg`` returns."""


def read(rec):
    c = rec["counters"]
    if not c.get("solves"):
        return None
    return c["iters"] / c["solves"]
