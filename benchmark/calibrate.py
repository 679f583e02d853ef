"""The readings that a cell's limits are set from: the program's compared
numbers over many seeds, and the control's (the reference in the next
precision down, in the program's place) over a few, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control_seeds 101 102 103 [--seconds 3]

Each seed is a whole run of the cell (set-up, a short window at the cell's
own sizes, the check); a line of JSON per run gives its checks and rate.
With `--faults`, each fault of benchmark/faults.py is planted in the
program for a run on each of `--fault_seeds`.
The limits in the cell's file do not matter here: only the readings do.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control_seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", default=[],
                        help="faults of benchmark/faults.py to plant, each on every fault seed")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from benchmark import faults, harness

    device = torch.device(args.device)
    runs = ([(s, False, None) for s in args.seeds] + [(s, True, None) for s in args.control_seeds]
            + [(s, False, f) for f in args.faults for s in args.fault_seeds])
    for seed, control, fault in runs:
        t = time.perf_counter()
        planted = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
        with contextlib.redirect_stdout(sys.stderr), planted:
            r = harness.run(args.workload, seed, args.seconds, False, device=device,
                            control=control)
        line = {"seed": seed, "control": control, "fault": fault,
                "seconds": time.perf_counter() - t,
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
