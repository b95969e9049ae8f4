"""Readings for the limits of ``correct``, many seeds in one process:

    python benchmark/calibrate.py --workload <cell> --seeds 11,12,13 [--control] [--fault <name>]

Each seed runs the cell as ``run.py`` does, with the shortest window (one
step, run on to the checked steps, in training; one cycle of the files in
inference), and prints one JSON line of the compared numbers. ``--control``
puts the reference with float8 operands (and, in training, float8
gradients) in the program's place; ``--fault`` plants one of the entries'
faults. Nothing here is run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    args = ap.parse_args()
    run._paths()
    import torch

    from harness import files

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = files.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run.run_cell(cell, seed, 0.0, False, torch.device("cuda", 0),
                           control=args.control, fault=args.fault)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault, "seconds": time.perf_counter() - t0,
                          **out["values"],
                          "worst_leaves": out["worst_leaves"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
