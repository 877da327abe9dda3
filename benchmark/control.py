"""Readings that set a cell's limits, the program's and the control's, on the card.

    python3 -m benchmark.control --workload <name> --seconds <s> --seeds <n> [<n> ...] \
        [--mode program|control|<fault>]

Each seed is one run of the cell in this process (`run.run_cell`, untraced),
its window `--seconds` long; the process pays its imports once.  `program`
runs the cell as it is (the lower readings), `control` with the family's
control in the program's place (the upper readings: TF-Bind's tables in
bfloat16, GFP's matrix products in TF32), and a fault's name (`faults.py`)
with that fault planted under the timed path.  Prints a JSON line per seed
with the numbers compared, then one with each number's largest and
smallest reading.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys

import torch

from benchmark import faults, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--mode", default="program",
                        choices=["program", "control", *sorted(faults.FAULTS)])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_cell(os.getcwd(), args.workload)
    planted = ()
    if args.mode in faults.FAULTS:
        import importlib

        from flexs_tpu_torch.runtime import jit_runner

        family = importlib.import_module(f"benchmark.families.{spec.config['family']}")
        planted = faults.swaps(args.mode, family, jit_runner)
    readings = []
    for seed in args.seeds:
        result = run.run_cell(spec, seed, args.seconds, False, "cuda",
                              control=args.mode == "control", faults=planted)
        numbers = {k: v["value"] for k, v in result["compared"].items()}
        readings.append(numbers)
        print(json.dumps({"mode": args.mode, "seed": seed, "correct": result["correct"],
                          "cells": result["attempted"], "compared": numbers,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()}}),
              flush=True)
    print(json.dumps({"mode": args.mode, "workload": args.workload, "seeds": args.seeds,
                      "max": {k: max(r[k] for r in readings) for k in readings[0]},
                      "min": {k: min(r[k] for r in readings) for k in readings[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
