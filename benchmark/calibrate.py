"""Readings for the correctness limits of a cell, on the card.

    python3 benchmark/calibrate.py --workload <name> --seconds <s> \
        --seeds 11 12 13

For each seed, in one process: a short window of the cell, then the
numbers that decide ``correct`` for the program and for the control (the
reference computed in the precision below the configuration's: float32
pair sums and bfloat16 SCF planes, put in the program's place).  One JSON
line per seed on standard output.  Exits 1 where the program is not
correct or the control is, on any seed.  The benchmark's own runs do not
run the control.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    rc = 0
    for seed in args.seeds:
        t = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               t_start=t, control=True)
        ok = res["correct"] and res.get("control_correct") is False
        rc = rc or (0 if ok else 1)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "control_correct": res.get("control_correct"),
                          "program": {k: v["value"] for k, v in
                                      res["checks"].items()},
                          "control": {k: v["value"] for k, v in
                                      res.get("control", {}).items()},
                          "reference": res.get("reference"),
                          "metrics": res["metrics"], "window": res["window"],
                          "device": res["device"]}), flush=True)
        if not ok:
            print(f"calibrate: seed {seed}: program correct "
                  f"{res['correct']}, control correct "
                  f"{res.get('control_correct')}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    harness.cache_env(ROOT)
    sys.exit(main())
