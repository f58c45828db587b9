#!/usr/bin/env python3
"""Readings of the ``correct`` comparison's numbers under the control or
a fault, at a cell's own size, on several seeds in one process.

    python3 portbench/control.py --workload NAME --seconds S
        --mode control|ed_altered|ed_half|align_altered|output_altered|sound
        --seeds N [N ...]

Each seed is one run of the cell (``harness.run_cell``, without a trace)
with the timed path broken by ``faults.fault(mode)`` (``sound``: not
broken); one JSON line a seed gives the numbers compared and whether the
run came out correct.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0")
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import faults
    from portbench.harness import run_cell
    from portbench.spec import load_cell

    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, root=ROOT, bench_dir=HERE)
    for seed in args.seeds:
        ctx = (contextlib.nullcontext() if args.mode == "sound"
               else faults.fault(args.mode))
        with ctx:
            res = run_cell(cell, seed, args.seconds, False, time.time())
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "checks": {k: v["value"]
                                     for k, v in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
