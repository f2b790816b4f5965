"""The check's two readings for one cell, on the chip, at the cell's own
size: the port's numbers over many seeds (the lower reading) and the
control's (the upper one), each run as the benchmark runs the cell, with a
short window, in one process.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 3

Prints one JSON line per run: who ran (``program`` or ``control``), the
seed, ``correct`` and each number compared. The control is the plain
reference in the program's place with its products in TF32
(``standins.control``). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness, standins


def readings(workload: str, seeds, control_seeds, seconds: float, device="cuda", shape=None):
    """Yield ``(who, seed, result)`` for every seed."""
    for who, build, group in (("program", None, seeds), ("control", standins.control, control_seeds)):
        for seed in group:
            result, _ = harness.run_cell(workload, seed, seconds, False, device, build=build, shape=shape)
            yield who, seed, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's readings for one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    for who, seed, r in readings(args.workload, seeds, control_seeds, args.seconds):
        numbers = {k: v["value"] for k, v in r["check"].items()}
        print(json.dumps({"who": who, "workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
