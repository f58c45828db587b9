"""The multi-process seam on one host (counterpart of
``scripts/dryrun_multihost.py``).

``run`` starts N worker processes of this module.  Each joins a gloo group
on a free localhost port, builds the global mesh of every process's local
devices (``distributed.make_global_mesh``) and runs edit distances (NW)
and alignments of the given pairs through an engine on that mesh: each
process launches the blocks of its own devices, and every process must
read the full result.  ``run`` waits for them with a timeout, kills them
when it expires, and raises on a failed or hung worker.

    python -m isocon_tpu_torch.parallel.dryrun [--procs 2] [--local 2]
        [--device cuda|cpu] [--timeout 120]

runs the seam on seeded pairs and holds every process's results to a
local engine's.  It runs on the card unless ``--device cpu`` asks for
logical CPU shards; without a card and without ``--device cpu`` it
raises.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VOLUME = ("ed_calls", "ed_pairs", "align_calls", "align_pairs",
          "align_overflows")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def engine_results(engine, ed_pairs, align_pairs, scores) -> dict:
    """What the seam compares: the NW distances of ``ed_pairs``, the
    alignments of ``align_pairs`` under ``scores``, the engine volume."""
    ed, _ = engine.edit_distances(ed_pairs)
    alns = engine.align_pairs(align_pairs, scores)
    return {"ed": [int(x) for x in ed],
            "alignments": [[a, b, list(c)] for a, b, c in alns],
            "volume": {k: engine.counters[k] for k in VOLUME}}


def _worker(args) -> None:
    import torch.distributed as dist

    from ..ops._build import LAUNCHES
    from ..ops.engine import PairEngine
    from . import distributed
    from .mesh import make_mesh
    from .sharding import Sharder

    with open(args.job) as fh:
        job = json.load(fh)
    distributed.initialize("127.0.0.1:%d" % args.port, args.procs,
                           args.rank, timeout_s=args.timeout)
    try:
        mesh = distributed.make_global_mesh(make_mesh(args.local,
                                                      args.device))
        engine = PairEngine(device=args.device, sharder=Sharder(mesh))
        out = engine_results(engine, [tuple(p) for p in job["ed_pairs"]],
                             [tuple(p) for p in job["align_pairs"]],
                             [tuple(s) for s in job["scores"]])
        out.update(rank=args.rank, mesh=[str(d) for d in mesh],
                   ranks=mesh.ranks, launches=dict(LAUNCHES))
        with open(args.out, "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def run(ed_pairs: Sequence[Tuple[str, str]],
        align_pairs: Sequence[Tuple[str, str]], scores, *, procs: int = 2,
        local=2, device: str = "cuda", timeout: float = 120.0,
        workdir: str = None) -> List[dict]:
    """Each process's ``engine_results`` on the global mesh of ``procs``
    processes with ``local`` devices each (an int, or one a process).
    Raises ``TimeoutError`` (the workers killed) or ``RuntimeError`` (a
    worker failed)."""
    if isinstance(local, int):
        local = [local] * procs
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as fh:
            json.dump({"ed_pairs": [list(p) for p in ed_pairs],
                       "align_pairs": [list(p) for p in align_pairs],
                       "scores": [list(s) for s in scores]}, fh)
        port = free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
        workers = []
        for rank in range(procs):
            out = os.path.join(tmp, "rank%d.json" % rank)
            log = open(os.path.join(tmp, "rank%d.log" % rank), "w+")
            cmd = [sys.executable, "-m", "isocon_tpu_torch.parallel.dryrun",
                   "--worker", str(rank), "--port", str(port), "--procs",
                   str(procs), "--local", str(local[rank]), "--device",
                   device, "--timeout", str(timeout), "--job", job,
                   "--out", out]
            workers.append((subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT), log, out))
        deadline = time.monotonic() + timeout
        try:
            for proc, _log, _out in workers:
                left = deadline - time.monotonic()
                try:
                    proc.wait(timeout=max(left, 0.1))
                except subprocess.TimeoutExpired:
                    raise TimeoutError("seam workers still running after "
                                       "%.0f s; killed" % timeout) from None
        finally:
            for proc, log, _out in workers:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            logs = []
            for _proc, log, _out in workers:
                log.seek(0)
                logs.append(log.read())
                log.close()
        results = []
        for rank, (proc, _log, out) in enumerate(workers):
            if proc.returncode != 0:
                raise RuntimeError("seam worker %d exited %d:\n%s"
                                   % (rank, proc.returncode,
                                      logs[rank][-4000:]))
            with open(out) as fh:
                results.append(json.load(fh))
        return results


def seeded_pairs(n: int, seed: int = 2):
    """Mutated pairs of 60-200 bases, an unrelated pair and an empty one."""
    rng = random.Random(seed)

    def rs(k):
        return "".join(rng.choice("ACGT") for _ in range(k))

    pairs = []
    for _ in range(n):
        a = rs(rng.randrange(60, 200))
        b = list(a)
        for _ in range(rng.randrange(0, 12)):
            p = rng.randrange(len(b))
            b[p] = rng.choice("ACGT")
        pairs.append((a, "".join(b)))
    pairs += [(rs(150), rs(120)), ("", "ACGT")]
    return pairs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--local", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--worker", type=int, dest="rank")
    p.add_argument("--port", type=int)
    p.add_argument("--job")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if args.rank is not None:
        _worker(args)
        return
    from ..ops.engine import PairEngine

    pairs = seeded_pairs(24)
    scores = [(2, -2, 2, 0)] * len(pairs)
    want = engine_results(PairEngine(device=args.device), pairs, pairs,
                          scores)
    got = run(pairs, pairs, scores, procs=args.procs, local=args.local,
              device=args.device, timeout=args.timeout)
    for r in got:
        for key in ("ed", "alignments", "volume"):
            if r[key] != want[key]:
                sys.exit("process %d: %s differs from the local engine's"
                         % (r["rank"], key))
        print("process %d of %d OK on a mesh of %d (%s)"
              % (r["rank"], args.procs, len(r["mesh"]), ", ".join(
                  "%s@%d" % x for x in zip(r["mesh"], r["ranks"]))))


if __name__ == "__main__":
    main()
