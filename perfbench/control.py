"""The readings the limits of ``correct`` are set from, for one cell.

    python3 perfbench/control.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]
                                 [--fault <kind>]

runs the cell once per seed in one process, each window closed as soon as
the step sampled for the check has run, and prints one JSON line per seed:
the numbers the program's run gives and what ``correct`` makes of them
and, for the control seeds, those that the reference computed one
precision lower (float64 → float32, float32 → bfloat16) gives in the
program's place, with what ``correct`` makes of those. ``--fault`` plants
one of ``perfbench/faults.py``'s faults under the timed path. A limit lies
above the largest program reading over a dozen seeds or more and below the
smallest control reading. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import faults  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=faults.KINDS)
    args = ap.parse_args(argv)
    import torch

    from perfbench.core import harness

    if not torch.cuda.is_available():
        print("perfbench: control readings are taken on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        planted = [faults.fault(args.fault)] if args.fault else []
        try:
            res, worst = harness.run_cell(args.workload, seed, 0.0, 0, "cuda:0", t0,
                                          faults=planted, control=seed in args.control_seeds)
        finally:
            for f in planted:
                f.undo()
        line = {"seed": seed, "fault": args.fault, "correct": res["correct"],
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "worst": worst, "control": res.get("control"),
                "control_correct": res.get("control_correct"),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
