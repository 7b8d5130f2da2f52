#!/usr/bin/env python3
"""Readings from which the correctness limits are set: the numbers that a
cell compares, over many seeds in one process, for the port or for the
control (the reference put in the port's place, in a lower precision).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--seconds 3] [--program port|bfloat16|float8]

For the port, each seed is a whole run with a short window; for the
control, set-up and the control's checked requests or steps, no window.
Prints each seed's numbers, then the largest and smallest of each.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", default="port")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    control = args.program != "port"
    kind = harness.cell(args.workload).traffic["kind"]
    units = 0 if control and kind == "train" else (2 if control else float("inf"))
    readings: dict[str, list[float]] = {}
    for seed in args.seeds:
        t = time.perf_counter()
        vals: dict[str, float] = {}
        r = harness.execute(args.workload, seed, float("inf") if control else args.seconds,
                            False, program=args.program, max_units=units,
                            log=lambda s: print(s, flush=True), readings=vals)
        for k, v in vals.items():
            readings.setdefault(k, []).append(v)
        print(f"calibrate {args.workload} {args.program} seed {seed}: {json.dumps(vals)} "
              f"correct {r['correct']} ({time.perf_counter() - t:.1f} s)", flush=True)
    for k, vs in readings.items():
        print(f"calibrate {args.workload} {args.program} {k}: max {max(vs)!r} min {min(vs)!r} "
              f"over {len(vs)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
