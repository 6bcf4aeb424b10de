"""Run one cell of the benchmark once and print its result line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs as many CUDA cards as the cell names; without them it exits with a
code other than 0 and prints no result.
"""

import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started,
    from its start in clock ticks since boot (``/proc/self/stat``, 10 ms
    steps); where ``/proc`` cannot say, the reading now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        now = time.perf_counter()
        return now - max(up - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T0 = process_start()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
