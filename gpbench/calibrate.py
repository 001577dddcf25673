"""Readings that the limits of ``correct`` are set from, for one cell, in
one process on the card:

- the program's numbers compared, on ``--seeds`` seeds (each a short run
  of the cell through the harness: set-up, a window of ``--seconds``, the
  check), whose largest is the lower reading;
- the control's (the reference in the program's place, in the precision
  below the configuration's) on ``--control-seeds`` seeds, and the same
  seeds' with only the control's solve in that precision
  (``control.solve``, its neighbours found in float64);
- each named fault's (``gpbench/faults.py``), planted in the program, on
  ``--fault-seeds`` seeds.

    python3 gpbench/calibrate.py --workload <cell> --first-seed <n>

Prints one JSON line a reading and a summary line: for each number, the
largest sound reading and the smallest control and fault readings.
Not part of a benchmark run.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpbench import faults
    from gpbench.harness import core

    if not torch.cuda.is_available():
        print("calibration reads the card", file=sys.stderr)
        return 3
    readings = {"program": [], "control": [], "control.solve": []}
    seed = args.first_seed

    def emit(kind, seed, numbers, correct=None):
        line = {"kind": kind, "seed": seed, "numbers": numbers}
        if correct is not None:
            line["correct"] = correct
        print(json.dumps(line), flush=True)
        readings.setdefault(kind, []).append(numbers)

    for _ in range(args.seeds):
        r = core.run_cell(ROOT, args.workload, seed, args.seconds, False)
        emit("program", seed, {k: c["value"] for k, c in r["checks"].items()},
             r["correct"])
        seed += 1
        torch.cuda.empty_cache()
    for _ in range(args.control_seeds):
        emit("control", seed, core.control_run(ROOT, args.workload, seed))
        emit("control.solve", seed, core.control_run(
            ROOT, args.workload, seed, solve_only=True))
        seed += 1
        torch.cuda.empty_cache()
    for name in filter(None, args.faults.split(",")):
        for _ in range(args.fault_seeds):
            r = core.run_cell(ROOT, args.workload, seed, args.seconds, False,
                              fault=faults.FAULTS[name])
            emit(f"fault.{name}", seed,
                 {k: c["value"] for k, c in r["checks"].items()},
                 r["correct"])
            seed += 1
            torch.cuda.empty_cache()
    summary = {}
    for kind, rows in readings.items():
        for key in rows[0] if rows else ():
            pick = max if kind == "program" else min
            summary.setdefault(key, {})[
                "lower" if kind == "program" else kind] = pick(
                    r[key] for r in rows)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
