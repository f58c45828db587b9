"""Device busy share of the port's phase 1, or of its whole pipeline, on
one CUDA card.

Writes a synthetic workload (``isocon_tpu_torch.workload``: the 10k-read
family, with ``--long`` the long-read family of 16.5-20 kb, or with
``--nontargeted`` four gene families, run with ``--nontargeted``), runs
``get_candidates`` (with ``--pipeline``: ``pipeline``) through
``isocon_tpu_torch.cli`` with ``--profile`` (a ``torch.profiler`` trace of
CPU ops and CUDA activity), and summarises the trace: wall seconds of the
profiled run, seconds in which the card ran a kernel, a copy or a fill
(union of those intervals), their share of the wall, and the device time
per kernel name.  With ``--pipeline`` the same figures are also given for
each phase, cut at the ``isocon_phase1`` / ``isocon_phase2`` spans that
``cli.run_pipeline`` records.  Prints one JSON line.

With ``--host`` it runs the same command under ``cProfile`` instead (no
torch profiler) and prints the port's functions with the most cumulative
host time: where the host, which holds the card idle, spends the run.

Usage: python tools/phase1_profile.py [--host] [--pipeline]
       [--long | --nontargeted] [N_READS] [WORKDIR]
       (defaults: 10000 reads, a temporary directory)
"""
from __future__ import annotations

import collections
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_seconds(events) -> float:
    """Length of the union of [ts, ts + dur) over ``events`` (us) in s."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total = 0.0
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def main() -> None:
    import torch

    from isocon_tpu_torch import cli
    from isocon_tpu_torch.workload import write_long_reads, write_reads

    if not torch.cuda.is_available():
        sys.exit("phase1_profile: no CUDA device")
    argv = sys.argv[1:]
    host = "--host" in argv
    which = "pipeline" if "--pipeline" in argv else "get_candidates"
    long_reads = "--long" in argv
    nontargeted = "--nontargeted" in argv
    argv = [a for a in argv if a not in ("--host", "--pipeline", "--long",
                                         "--nontargeted")]
    n_reads = int(argv[0]) if argv else 10000
    work = argv[1] if len(argv) > 1 else tempfile.mkdtemp()
    os.makedirs(work, exist_ok=True)
    reads = os.path.join(work, "reads.fa")
    if long_reads:
        write_long_reads(reads, n_reads)
    else:
        write_reads(reads, n_reads, families=4 if nontargeted else 1)
    out = os.path.join(work, "out")
    mode = ["--nontargeted"] if nontargeted else []
    if host:
        prof = cProfile.Profile()
        prof.runcall(cli.main, [which, "-fl_reads", reads,
                                "-outfolder", out, "--device", "cuda", *mode])
        stats = pstats.Stats(prof)
        stats.sort_stats("cumulative").print_stats("isocon_tpu_torch", 60)
        return
    t0 = time.perf_counter()
    engine = cli.main([which, "-fl_reads", reads, "-outfolder", out,
                       "--device", "cuda", "--profile", *mode])
    if which == "pipeline":
        engine = engine[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "torch_trace.json")) as fh:
        trace = json.load(fh)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    span = ((max(e["ts"] + e["dur"] for e in events)
             - min(e["ts"] for e in events)) / 1e6 if events else 0.0)
    per_kernel = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = per_kernel[e["name"][:60] if e["cat"] == "kernel" else e["cat"]]
        k[0] += 1
        k[1] += e["dur"] / 1e6
    busy = busy_seconds(dev)
    phases = {}
    for e in events:
        if e.get("name") in ("isocon_phase1", "isocon_phase2"):
            lo, hi = e["ts"], e["ts"] + e["dur"]
            inside = [d for d in dev if lo <= d["ts"] < hi]
            b = busy_seconds(inside)
            phases[e["name"]] = {
                "span_s": e["dur"] / 1e6, "device_busy_s": b,
                "device_idle_share": 1.0 - b / (e["dur"] / 1e6)}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "n_reads": n_reads, "long_reads": long_reads,
        "nontargeted": nontargeted,
        "wall_s": wall,
        "trace_span_s": span, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / span if span else None,
        "phases": phases,
        "ed_seconds": engine.counters["ed_seconds"],
        "align_seconds": engine.counters["align_seconds"],
        "device_time_by_name": {k: {"count": c, "s": s}
                                for k, (c, s) in top},
    }))


if __name__ == "__main__":
    main()
