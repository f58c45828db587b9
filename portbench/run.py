#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

Usage (from the root of a checkout):

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell, its configuration, traffic, checks and metrics are found by
name from ``BENCHMARK.json`` (see ``spec.py``); the run itself is
``harness.run_cell``.  With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window and the program's counters.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error give the same numbers and limits.

The run re-executes itself with PYTHONHASHSEED=0: the row order of
``cluster_info.tsv`` follows the iteration order of sets of read names,
so a pinned hash seed gives the parent and a change the same jobs.  It
exits non-zero with no result without CUDA or with fewer cards than the
cell asks for, and when the process holds ``jax``, ``jaxlib``, ``flax``
or ``isocon_tpu`` (top-level names, compared whole) after the window.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's and the libraries' build and kernel caches, at fixed paths
# inside the checkout (the program builds its kernels into its own
# isocon_tpu_torch/_build/)
CACHE = os.path.join(ROOT, ".portbench_cache")
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
             "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
             "CUDA_CACHE_PATH": os.path.join(CACHE, "nv_compute")}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0",
                   PORTBENCH_T_START=repr(T_START))
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    t_start = float(os.environ.get("PORTBENCH_T_START", T_START))
    os.environ.update(CACHE_ENV)
    sys.path.insert(0, ROOT)

    from portbench.spec import load_cell
    cell = load_cell(args.workload, root=ROOT, bench_dir=HERE)

    import torch
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print("portbench: %d cards, the cell asks for %d"
              % (torch.cuda.device_count(), cell.chips), file=sys.stderr)
        return 2

    from portbench.harness import run_cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
