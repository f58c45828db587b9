"""The spans and counters the port records for a profiler trace.

``pipeline`` through ``cli.parse`` on a small seeded FASTA (two
isoforms, 3 SNVs apart, x 8 noisy reads of 120 bases), ``--device cpu``:

* under ``torch.profiler`` (host activity): every layer span
  (``isocon_phase1.*``, ``isocon_phase2.*``) and engine span
  (``isocon_engine.*``) is recorded inside its phase span; each layer span
  is entered once an iteration or round that runs its step, as the
  logfile's ``Iteration`` and ``stat_filter STEP NR`` lines count them;
  the layers' self times (less the engine spans nested in them) are >= 0
  and sum to no more than their phase;
* with the plain K1/K2/K5 on the CPU (``ISOCON_NO_NATIVE=1``, so that
  edit distances are collected too): ``fetch_bytes`` equals the bytes the
  sharder's collects returned, ``upload_bytes`` those sent through
  ``parallel.sharding.upload``, and the waits and the decode lie within
  the engine's seconds.
"""
import os
import random
import re

import pytest
from torch.profiler import ProfilerActivity, profile

from isocon_tpu_torch import cli
from isocon_tpu_torch.ops import engine as engine_mod
from isocon_tpu_torch.parallel import sharding
from test_torch_candidates import noisy_copy, rand_seq
from test_torch_native import plain_port_routes

LAYERS = {
    "isocon_phase1": ("nn_graph", "partition", "align", "correct"),
    "isocon_phase2": ("static_graph", "assign", "tests"),
}
ENGINE = ("isocon_engine.ed_nw", "isocon_engine.ed_hw",
          "isocon_engine.align")


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    rng = random.Random(5)
    base = rand_seq(rng, 120)
    snv = list(base)
    for pos in (20, 60, 100):
        snv[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[snv[pos]]
    path = str(tmp_path_factory.mktemp("spans") / "reads.fa")
    with open(path, "w") as fh:
        for k, iso in enumerate((base, "".join(snv)) * 8):
            fh.write(">r%d\n%s\n" % (k, noisy_copy(rng, iso, 0.02)))
    return path


def _pipeline(reads_fa, out):
    run, params = cli.parse(["pipeline", "-fl_reads", reads_fa,
                             "-outfolder", out, "--device", "cpu"])
    try:
        engine, _phase1 = run(params)
    finally:
        params.logfile.close()
    with open(os.path.join(out, "logfile.txt")) as fh:
        return engine, fh.read()


@pytest.fixture(scope="module")
def traced(reads_fa, tmp_path_factory):
    """(the host spans as (name, start ns, end ns), the logfile)."""
    out = str(tmp_path_factory.mktemp("traced"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _engine, log = _pipeline(reads_fa, out)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("isocon_")]
    return spans, log


def _union(intervals):
    total, cur0, cur1 = 0, None, None
    for lo, hi in sorted(intervals):
        if cur1 is None or lo > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = lo, hi
        else:
            cur1 = max(cur1, hi)
    return total + (cur1 - cur0 if cur1 is not None else 0)


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def test_every_span_nests_in_its_phase(traced):
    spans, _log = traced
    phases = {p: [s for s in spans if s[0] == p] for p in LAYERS}
    assert all(len(v) == 1 for v in phases.values()), phases
    for phase, layers in LAYERS.items():
        for layer in layers:
            got = [s for s in spans if s[0] == phase + "." + layer]
            assert got, phase + "." + layer
            assert all(_inside(s, phases[phase][0]) for s in got)
    for name in ENGINE:
        got = [s for s in spans if s[0] == name]
        assert got, name
        assert all(any(_inside(s, ph[0]) for ph in phases.values())
                   for s in got)


def test_layer_spans_are_entered_once_a_step(traced):
    spans, log = traced
    count = {name: sum(1 for s in spans if s[0] == name)
             for name, _lo, _hi in spans}
    # phase 1: "Iteration k: ..., E NN edges, ..." a pass of the loop; a
    # pass whose strings have converged (no NN edges) skips the NN graph
    # and the partition; every pass after the first follows a correction;
    # the final read -> candidate alignments are one more align
    edges = [int(e) for e in re.findall(r"Iteration \d+: .*?, (\d+) NN edges",
                                        log)]
    assert len(edges) >= 2
    searched = sum(1 for e in edges if e > 0)
    assert count["isocon_phase1.nn_graph"] == searched
    assert count["isocon_phase1.partition"] == searched
    assert count["isocon_phase1.align"] == len(edges) + 1
    assert count["isocon_phase1.correct"] == len(edges) - 1
    # phase 2: a round's line gives its new tests and reads realigned
    rounds = [(int(t), int(r)) for t, r in re.findall(
        r"stat_filter STEP NR \d+: \d+ candidates, (\d+) new tests, "
        r"\d+ memoized, (\d+) reads realigned", log)]
    assert rounds
    assert count["isocon_phase2.static_graph"] == 1
    assert count["isocon_phase2.assign"] == sum(1 for _t, r in rounds if r)
    assert count["isocon_phase2.tests"] == sum(1 for t, _r in rounds if t)
    assert count["isocon_phase2.tests"] >= 1


def test_layer_self_times_fit_their_phase(traced):
    spans, _log = traced
    engine = [s for s in spans if s[0].startswith("isocon_engine.")]
    for phase, layers in LAYERS.items():
        (p,) = [s for s in spans if s[0] == phase]
        total = 0
        for layer in layers:
            for s in (x for x in spans if x[0] == phase + "." + layer):
                nested = [(max(e[1], s[1]), min(e[2], s[2]))
                          for e in engine if s[1] <= e[1] < s[2]]
                own = (s[2] - s[1]) - _union(nested)
                assert own >= 0
                total += own
        assert 0 < total <= p[2] - p[1]


def test_engine_counters_of_fetches_uploads_and_waits(reads_fa, tmp_path,
                                                      monkeypatch):
    fetched, sent = [], []
    collect = sharding.Sharder.collect

    def counting_collect(self, batch):
        res = collect(self, batch)
        fetched.append(sum(a.nbytes for a in res))
        return res

    def counting_upload(upload):
        def wrapped(arr, device):
            sent.append(arr.nbytes)
            return upload(arr, device)
        return wrapped

    monkeypatch.setattr(sharding.Sharder, "collect", counting_collect)
    monkeypatch.setattr(sharding, "upload", counting_upload(sharding.upload))
    monkeypatch.setattr(engine_mod, "upload",
                        counting_upload(engine_mod.upload))
    with plain_port_routes():
        engine, _log = _pipeline(reads_fa, str(tmp_path))
    c = engine.counters
    assert c["ed_pairs"] > 0 and c["align_pairs"] > 0
    assert fetched and c["fetch_bytes"] == sum(fetched)
    assert sent and c["upload_bytes"] == sum(sent)
    engine_s = c["ed_seconds"] + c["align_seconds"]
    for key in ("ed_wait_seconds", "align_wait_seconds",
                "align_decode_seconds"):
        assert 0 < c[key] <= engine_s, key
    assert (c["ed_wait_seconds"] + c["align_wait_seconds"]
            + c["align_decode_seconds"]) <= engine_s
    assert c["ed_wait_seconds"] <= c["ed_seconds"]
    assert (c["align_wait_seconds"] + c["align_decode_seconds"]
            <= c["align_seconds"])
