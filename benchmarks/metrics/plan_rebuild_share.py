"""Share of the SELL products that rebuilt a K1 launch plan for a key
whose plan had gone stale: the program's counters ``sell_plan.rebuilds``
over ``sell_plan.hits + sell_plan.builds`` (every product through a plan
either reused one or built one).

A ``SellMatrix`` builds a plan on its first product of a (batch rows, x
width, device, stream) key, at warm-up here, and reuses it while the
matrix holds the tensors it was built from; a replaced ``vals``, ``idx``
or ``scales`` makes the key's next product build anew. The reading is 0
while plans are reused, and 1/16 if one layer of a 16-layer stack rebuilt
on every pass. The counters run from the process's start and are never
reset; a rebuild is never part of warm-up's first builds, so the reading
does not hang on the run's length. Only a program module the run has
loaded is read; a program without the counters, or a run with no SELL
product, gives None."""

import sys


def read(rec):
    plan = getattr(sys.modules.get("tpusparse_torch.kernels.sell_spmv"),
                   "sell_plan", None)
    counts = [getattr(plan, k, None) for k in ("rebuilds", "hits", "builds")]
    if None in counts or not counts[1] + counts[2]:
        return None
    return counts[0] / (counts[1] + counts[2])
