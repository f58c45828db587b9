"""Host<->device copies and host waits in a ``torch.profiler`` trace.

Reads the ``torch_trace.json`` that ``cli --profile`` writes (for
example under ``tools/phase1_profile.py``'s WORKDIR/out) and prints one
JSON line: for the whole trace and for each phase span
(``isocon_phase1`` / ``isocon_phase2``), the count and device seconds of
each kind of copy on the card (the trace's ``gpu_memcpy`` events by name:
HtoD, DtoH, DtoD, with their pageable or pinned side) and of fills
(``gpu_memset``), and the count and host seconds of the CUDA runtime
calls that copy or wait (``cudaMemcpy*``, ``cuda*Synchronize``,
``cudaEventQuery``).

Usage: python tools/trace_copies.py TRACE_JSON
"""
from __future__ import annotations

import collections
import json
import sys

RUNTIME_KEYS = ("cudaMemcpy", "Synchronize", "cudaEventQuery",
                "cudaHostAlloc")


def summarise(events):
    """{name: [count, seconds]} of the device copies and fills and of the
    runtime calls that copy or wait, among ``events``."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat in ("gpu_memcpy", "gpu_memset"):
            key = "device: " + (name if cat == "gpu_memcpy" else "memset")
        elif cat == "cuda_runtime" and any(k in name for k in RUNTIME_KEYS):
            key = "host: " + name
        else:
            continue
        out[key][0] += 1
        out[key][1] += e["dur"] / 1e6
    return {k: {"count": c, "s": s} for k, (c, s) in sorted(out.items())}


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    with open(sys.argv[1]) as fh:
        trace = json.load(fh)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    result = {"all": summarise(events)}
    for span in events:
        if span.get("name") in ("isocon_phase1", "isocon_phase2"):
            lo, hi = span["ts"], span["ts"] + span["dur"]
            result[span["name"]] = summarise(
                [e for e in events if lo <= e["ts"] < hi])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
