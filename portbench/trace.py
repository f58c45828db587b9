"""Reading a ``torch.profiler`` chrome trace of the window.

``busy_seconds`` is a frozen copy of ``tools/phase1_profile.py``
(commit 2110776) and ``summarise`` of ``tools/trace_copies.py`` (same
commit): the union of the device's kernel, copy and fill intervals, and
the copies, fills and host waits by kind.  The traced window is the
jobs' own spans (``portbench.job``, ``spans_of``): what lies between
them is the benchmark's own work, outside the window's clock.
``idle_gaps`` names each stretch of a job in which the card ran nothing
by the innermost host span that covers its middle: the program's phase
spans (``isocon_phase1``, ``isocon_phase2``), the benchmark's own spans
around the engine's calls (``portbench.*``), or the job.
"""
from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_KEYS = ("cudaMemcpy", "Synchronize", "cudaEventQuery",
                "cudaHostAlloc")
SPAN_PREFIXES = ("isocon_phase", "portbench.")
ENGINE_SPANS = ("portbench.ed_", "portbench.align")


def load_events(path: str) -> List[dict]:
    """The complete ('X') events of a chrome trace file."""
    with open(path) as fh:
        trace = json.load(fh)
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def spans_of(events: List[dict], name: str) -> List[Tuple[float, float]]:
    """The sorted [start, end) (us) of the host spans called ``name``."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == name
                  and e.get("cat") in ("user_annotation", "cpu_op"))


def within(events: List[dict], spans) -> List[dict]:
    """The events that start inside one of ``spans`` (sorted, disjoint),
    each clipped to its span's end."""
    starts = [lo for lo, _hi in spans]
    out = []
    for e in events:
        k = bisect.bisect_right(starts, e["ts"]) - 1
        if k >= 0 and e["ts"] < spans[k][1]:
            end = min(e["ts"] + e["dur"], spans[k][1])
            out.append(dict(e, dur=end - e["ts"]))
    return out


def device_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


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


def kernel_seconds(events: List[dict], patterns) -> float:
    """Device seconds of the kernels whose name holds one of
    ``patterns``."""
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel"
               and any(p in e.get("name", "") for p in patterns)) / 1e6


def device_ops(events: List[dict], top: int = 10) -> List[Tuple[str, float]]:
    """The device operations (kernels by name, copies and fills by kind)
    that took the most seconds."""
    by = collections.defaultdict(float)
    for e in device_events(events):
        name = e["name"] if e["cat"] != "gpu_memset" else "memset"
        by[name] += e["dur"] / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def idle_gaps(events: List[dict], spans, top: int = 10
              ) -> List[Tuple[str, float]]:
    """Seconds in which the card ran nothing within ``spans`` (us; sorted,
    disjoint), summed by the innermost host span over each gap's middle,
    the largest first."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events(events))
    gaps = []
    k = 0
    for lo, hi in spans:
        cur = lo
        while k < len(dev) and dev[k][1] <= lo:
            k += 1
        j = k
        while j < len(dev) and dev[j][0] < hi:
            s, e = dev[j]
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
            j += 1
        if cur < hi:
            gaps.append((cur, hi))
    named = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") in ("user_annotation", "cpu_op")
             and e.get("name", "").startswith(SPAN_PREFIXES)]
    # the engine's calls (many, never nested) and the rest (jobs, phases)
    fine = sorted(s for s in named if s[2].startswith(ENGINE_SPANS))
    coarse = [s for s in named if not s[2].startswith(ENGINE_SPANS)]
    starts = [s[0] for s in fine]
    by: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        k = bisect.bisect_right(starts, mid)
        name = None
        if k and fine[k - 1][1] > mid:
            name = fine[k - 1][2]
        else:
            inner = [s for s in coarse if s[0] <= mid < s[1]]
            if inner:
                name = max(inner, key=lambda s: (s[0], -s[1]))[2]
        by[name or "other"] += (g1 - g0) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]
