"""Read a cell's compared numbers for several seeds in one process: the
program's, or with ``--control`` the lower-precision control's (the
configuration's plain reference in the program's place, from
``reference/<config>.py``). The limits in ``configs/<config>.json`` are set
from these readings; the benchmark's own runs never run the control.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control]

Prints one JSON line per seed: the numbers compared, and whether they pass
the limits as they stand.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402

from benchmarks import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the readings are taken on the card",
              file=sys.stderr)
        return 3
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = harness.load_json("configs", cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        system = harness.load_module("reference", cell["config"]).Control(
            cfg) if args.control else None
        line = harness.run_cell(bench, args.workload, seed, args.seconds,
                                False, torch.device("cuda", 0),
                                system=system)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"],
                          "metrics": line["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
