"""Self time of the program's layer spans in the traced window.

A layer span is a step of a pipeline phase that the program records
(``isocon_phase1.nn_graph``, ``isocon_phase2.tests``, ...).  Its self
time is its duration less the union of the intervals of the spans nested
in it whose names start with ``isocon_engine.`` (the engine's calls) or
``portbench.`` (the benchmark's recorder around them, which does its own
work after the engine returns): the host's own work in that layer, the
engine's calls and their waits left out.  A nested span is a host span
that lies within the layer span (to the trace's nanosecond, ``SLACK_US``).
Only spans of the traced window count (``trace.within`` of the jobs'
spans, each clipped to its job's end).
"""
from __future__ import annotations

import bisect
from typing import List, Optional

from . import trace

CHILD_PREFIXES = ("isocon_engine.", "portbench.")
HOST_CATS = ("user_annotation", "cpu_op")
SLACK_US = 1e-3     # a chrome trace's times are us to three decimals


def _named(events: List[dict], name: str) -> List[dict]:
    """The host spans called ``name`` or named as a child."""
    return [e for e in events if e.get("cat") in HOST_CATS
            and (e.get("name") == name
                 or e.get("name", "").startswith(CHILD_PREFIXES))]


def self_seconds(events: List[dict], name: str, windows) -> Optional[float]:
    """Summed self time (s) of the host spans called ``name`` among
    ``events`` inside ``windows`` (us; sorted, disjoint); None where there
    is no such span."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in trace.within(_named(events, name), windows))
    parents = [(lo, hi) for lo, hi, n in spans if n == name]
    if not parents:
        return None
    kids = [(lo, hi) for lo, hi, n in spans if n.startswith(CHILD_PREFIXES)]
    starts = [lo for lo, _hi in kids]
    total = 0.0
    for p0, p1 in parents:
        covered = 0.0
        cur0 = cur1 = None
        for c0, c1 in kids[bisect.bisect_left(starts, p0):
                           bisect.bisect_left(starts, p1)]:
            if c1 > p1 + SLACK_US:
                continue
            c1 = min(c1, p1)
            if cur1 is None or c0 > cur1:
                if cur1 is not None:
                    covered += cur1 - cur0
                cur0, cur1 = c0, c1
            else:
                cur1 = max(cur1, c1)
        if cur1 is not None:
            covered += cur1 - cur0
        total += (p1 - p0) - covered
    return total / 1e6


def per_job(run, name: str) -> Optional[float]:
    """``self_seconds`` of the layer span ``name`` over the traced window,
    a job; None without a trace or without the span (a program that does
    not record it)."""
    if run.events is None or not run.trace_spans:
        return None
    secs = self_seconds(run.events, name, run.trace_spans)
    return None if secs is None else secs / len(run.trace_spans)
