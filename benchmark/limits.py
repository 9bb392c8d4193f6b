#!/usr/bin/env python3
"""Readings that a cell's limits are set from (not part of the benchmark's runs):

    python3 benchmark/limits.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--first-seed N] [--seconds 1]

In one process, for each of `--seeds` seeds it makes a run of the cell (a short window
at the cell's own load and sizes, judged as `run.py` judges it) and prints each number
compared; then the same for `--control-seeds` seeds with the configuration's `control`
section laid over its `program` section (the program's own lower-precision path). The
summary gives, for each number, the largest sound reading, the smallest control
reading and their ratio. With `--fault <name>` every run has that fault of
`harness/faults.py` planted (a fault's readings are upper readings too; in every rank of
a cell on more than one card, whose runs start their other ranks each time). Each limit
in `limits/<cell>.json` lies between the two (PERF.md gives the readings each was set
from).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", default=None,
                   help="plant a fault of harness/faults.py in every run (no control runs)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import contextlib

    from benchmark.harness.cell import resolve
    from benchmark.harness.faults import FAULTS
    from benchmark.harness.runner import run

    if not torch.cuda.is_available():
        print("limits.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    seen = {False: {}, True: {}}
    runs = [(args.first_seed + i, False) for i in range(args.seeds)]
    if args.fault is None:
        runs += [(args.first_seed + 1000 + i, True) for i in range(args.control_seeds)]
    for seed, control in runs:
        with FAULTS[args.fault](cell) if args.fault else contextlib.nullcontext():
            result, checks = run(cell, seed, args.seconds, False, "cuda", control=control)
        values = {k: c["value"] for k, c in checks.items()}
        print(json.dumps({"seed": seed, "control": control, "fault": args.fault,
                          "correct": result["correct"], "readings": values}), flush=True)
        for k, v in values.items():
            seen[control].setdefault(k, []).append(v)
    summary = {}
    for k, sound in seen[False].items():
        ctrl = seen[True].get(k, [])
        summary[k] = {"sound_max": max(sound), "control_min": min(ctrl) if ctrl else None,
                      "ratio": min(ctrl) / max(sound) if ctrl and max(sound) > 0 else None,
                      "limit": cell.limits.get(k)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
