"""The pooled nine-family configuration, its cell ``nontargeted_pipeline``,
the three readers of the sketch (``sketch_s``, ``sketch_profile_s``,
``sketch_roofline``), ``counts_sketch`` and the benchmark's copy of the
sketch reference, on the CPU."""
import json
import os
import random

import numpy as np
import pytest
import torch

from portbench import counts_sketch, generator, harness, spec
from portbench import sketch_reference as bench_ref

SKETCH_METRICS = ("sketch_s", "sketch_profile_s", "sketch_roofline")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_nontargeted_cell_loads():
    cell = spec.load_cell("nontargeted_pipeline")
    assert cell.chips == 1
    assert cell.config["name"] == "multi_family"
    assert cell.traffic["subcommand"] == "pipeline"
    assert cell.traffic["args"] == ["--nontargeted"]
    assert cell.traffic["loop"] == "closed" and cell.traffic["clients"] == 1
    assert [m.name for m in cell.end_to_end] == ["reads_per_s", "setup_s"]
    # the three of the sketch, after every older metric that reads a layer
    # this cell runs: all but the long route's (K5 never runs at 2 kb)
    names = [m.name for m in cell.per_layer]
    assert names[-3:] == list(SKETCH_METRICS)
    targeted = [m.name for m in spec.load_cell("targeted_pipeline").per_layer]
    assert names[:-3] == targeted and len(targeted) == 24
    assert not {"wave_roofline", "wave_wait_s", "wave_rerun_share"} & set(
        names)
    assert cell.checks["sample"] == {"ed_nw": 8192, "ed_hw": 4096,
                                     "align": 2048}
    assert set(cell.checks["limits"]) == {
        "ed_nw_wrong", "ed_hw_wrong", "align_wrong", "jobs_failed",
        "cluster_errors", "isoforms_missed", "candidates_extra"}
    for name in ("ed_nw_wrong", "ed_hw_wrong", "align_wrong",
                 "cluster_errors", "jobs_failed"):
        assert cell.checks["limits"][name] == 0
    for old in ("targeted_pipeline", "long_pipeline"):
        names = {m.name for m in spec.load_cell(old).per_layer}
        assert not set(SKETCH_METRICS) & names


def test_nine_families_use_disjoint_exons():
    conf = spec.load_cell("nontargeted_pipeline").config
    with open(os.path.join(ROOT, "portbench", "configs",
                           "targeted_ccs.json")) as fh:
        one = json.load(fh)
    assert len(conf["exon_lens"]) == 54 and len(conf["combos"]) == 117
    assert conf["exon_lens"][:6] == one["exon_lens"]
    rng = np.random.default_rng(4601)
    for f in range(1, 9):
        assert conf["exon_lens"][6 * f:6 * f + 6] == \
            rng.integers(120, 450, 6).tolist()
    for f in range(9):
        combos = conf["combos"][13 * f:13 * f + 13]
        assert combos == [[e + 6 * f for e in c] for c in one["combos"]]
    assert conf["reduced"] == {} and conf["reads_per_job"] == 10000


def test_generator_gives_234_distinct_isoforms():
    conf = spec.load_cell("nontargeted_pipeline").config
    iso, reads = generator.make_job(conf, 2 ** 31 + 4601, 0, 468)
    assert len(iso) == len(set(iso)) == conf["isoforms"] == 234
    lens = [len(s) for s in iso]
    assert [min(lens), max(lens)] == conf["isoform_bases"] == [719, 1985]
    assert abs(np.mean(lens) - 1166) < 1
    # round-robin: read i is a noisy copy of isoform i mod 234
    got = np.array([len(r) for r in reads])
    want = np.array([lens[i % 234] for i in range(468)])
    assert np.abs(got - want).max() < 0.05 * want.max()
    # the families share no exon: isoforms of two families share no 40-mer
    kmers = [{s[p:p + 40] for p in range(0, len(s) - 40, 10)} for s in iso]
    for f in range(1, 9):
        assert not kmers[0] & kmers[26 * f]


def _job(counters):
    return harness.Job(reads=10000, seconds=20.0, phase_s={1: 15.0, 2: 5.0},
                       counters_phase1=None, counters_end=counters,
                       launches_phase1=None, launches_end={})


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _readers():
    return {name: spec.load_reader(name) for name in SKETCH_METRICS}


TILE = "void (anonymous namespace)::sketch_tile_kernel<false>(...)"
MERGE = "void (anonymous namespace)::sketch_merge_kernel(...)"


def test_readers_read_nothing_without_the_counters_or_span():
    """The parent's engine keeps neither new counter and its program no
    ``isocon_phase1.sketch`` span: every reader gives None."""
    read = _readers()
    run = harness.Run(cell=None, seed=1)
    for name in SKETCH_METRICS:
        assert read[name](run) is None, name
    run.jobs = [_job({"sketch_rows": 10000, "sketch_seconds": 5.0})]
    run.clock_mhz = 1980.0
    run.events = [_ev("user_annotation", "portbench.job", 0, 1e6),
                  _ev("user_annotation", "isocon_phase1.nn_graph", 10, 9e5),
                  _ev("kernel", TILE, 100, 3000)]
    run.trace_spans = [(0, 1e6)]
    for name in SKETCH_METRICS:
        assert read[name](run) is None, name


def test_readers_on_a_recorded_run():
    read = _readers()
    run = harness.Run(cell=None, seed=1)
    cells = [10000 * 9999 // 2 + 1102 * 1101 // 2, 9000 * 8999 // 2]
    rows = [11102, 9000]
    run.jobs = [_job({"sketch_rows": r, "sketch_score_cells": c,
                      "sketch_profile_seconds": p, "sketch_pairs": 20 * r})
                for r, c, p in zip(rows, cells, (4.5, 3.5))]
    assert read["sketch_profile_s"](run) == pytest.approx(4.0)
    run.clock_mhz = 1980.0
    run.events = [
        _ev("user_annotation", "portbench.job", 0, 1e6),
        _ev("user_annotation", "isocon_phase1.nn_graph", 100, 6e5),
        _ev("user_annotation", "isocon_phase1.sketch", 200, 5e5),
        # the rescoring's engine call: inside nn_graph, not inside sketch
        _ev("user_annotation", "isocon_engine.ed_nw", 5.5e5, 1e5),
        _ev("kernel", TILE, 1000, 2900.0),
        _ev("kernel", MERGE, 4000, 30.0),
        _ev("kernel", "void (anonymous namespace)::myers_band_kernel<7>()",
            5.6e5, 5000),
        _ev("user_annotation", "portbench.job", 2e6, 1e6),
        _ev("user_annotation", "isocon_phase1.sketch", 2.1e6, 3e5),
        _ev("kernel", TILE, 2.2e6, 2500.0),
        # between the jobs: outside the window
        _ev("kernel", TILE, 1.5e6, 9000.0),
    ]
    run.trace_spans = [(0, 1e6), (2e6, 3e6)]
    assert read["sketch_s"](run) == pytest.approx((0.5 + 0.3) / 2)
    ops, nbytes = counts_sketch.sketch_work(sum(cells), sum(rows))
    least, by = counts_sketch.bound_s(nbytes, ops, 1980.0)
    assert by == "operations"
    got = read["sketch_roofline"](run)
    assert got == pytest.approx(100.0 * least / (5430e-6))
    assert 0 < got <= 100


def test_counts_sketch_gives_the_smoke_bound():
    # 10,000 x 9,999 / 2 distinct scores of 514 operations
    ops, nbytes = counts_sketch.sketch_work(10000 * 9999 // 2, 10000)
    least, by = counts_sketch.bound_s(nbytes, ops, 1980.0)
    assert by == "operations"
    assert least * 1e3 == pytest.approx(0.768, abs=5e-4)
    assert nbytes == 10000 * (512 * 4 + 4 + 20 * 12)


def test_benchmark_reference_equals_the_repos():
    from isocon_tpu_torch.graph import sketch_reference as repo_ref

    rng = random.Random(23)
    fam = ["".join(rng.choice("ACGT") for _ in range(n))
           for n in (120, 90, 150)]
    iso = [fam[0] + fam[1] + fam[2], fam[0] + fam[2], fam[1] + fam[2]]

    def noisy(s):
        out = []
        for c in s:
            r = rng.random()
            if r < 0.004:
                continue
            out.append(rng.choice("ACGT") if r < 0.008 else c)
            if r > 0.997:
                out.append(rng.choice("ACGT"))
        return "".join(out)

    seqs = sorted({noisy(iso[i % 3]) for i in range(45)})
    conv = [i % 4 == 0 for i in range(len(seqs))]
    lens = [len(s) for s in seqs]
    for name in ("profiles",):
        a = getattr(bench_ref, name)(seqs)
        b = getattr(repo_ref, name)(seqs)
        assert torch.equal(a, b)
    prof = repo_ref.profiles(seqs)
    for a, b in zip(bench_ref.scores(prof, lens), repo_ref.scores(prof, lens)):
        assert torch.equal(a, b)
    assert bench_ref.matches(seqs, 6) == repo_ref.matches(seqs, 6)
    pairs = [(seqs[i], seqs[j]) for i in range(len(seqs))
             for j in range(0, len(seqs), 7)]
    assert np.array_equal(bench_ref.nw_distances(pairs),
                          repo_ref.nw_distances(pairs))
    want = repo_ref.nn_graph(seqs, conv, 6)
    assert bench_ref.nn_graph(seqs, conv, 6) == want and any(want)
    idx = repo_ref.top_n(repo_ref.scores(prof, lens)[0], 6)[1]
    assert bench_ref.check_rows(prof, lens, list(range(len(seqs))), idx,
                                topn=6) == repo_ref.check_rows(
        prof, lens, list(range(len(seqs))), idx, topn=6)
