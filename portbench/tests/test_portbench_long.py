"""The whole-mtDNA configuration, its cell and the three readers of the
long route (``wave_roofline``, ``wave_wait_s``, ``wave_rerun_share``), on
the CPU."""
import numpy as np
import pytest

from portbench import counts, generator, harness, spec
from portbench.recorder import Recorder

WAVE_METRICS = ("wave_roofline", "wave_wait_s", "wave_rerun_share")
# rCRS length, the common deletion's span (m.8470_13446del) and what is
# left of the molecule without it
RCRS, DEL_FIRST, DEL_LAST = 16569, 8470, 13446
DELETED = RCRS - (DEL_LAST - DEL_FIRST + 1)


def test_long_cell_loads():
    cell = spec.load_cell("long_pipeline")
    assert cell.chips == 1
    assert cell.config["name"] == "mtdna_hifi"
    assert cell.traffic["subcommand"] == "pipeline"
    assert [m.name for m in cell.end_to_end] == ["reads_per_s", "setup_s"]
    names = [m.name for m in cell.per_layer]
    assert names == list(WAVE_METRICS)
    assert set(cell.checks["limits"]) == {
        "ed_nw_wrong", "ed_hw_wrong", "align_wrong", "jobs_failed",
        "cluster_errors", "isoforms_missed", "candidates_extra"}
    for name in ("ed_nw_wrong", "ed_hw_wrong", "align_wrong",
                 "cluster_errors", "jobs_failed"):
        assert cell.checks["limits"][name] == 0
    # the older cell does not report the new readers
    old = spec.load_cell("targeted_pipeline")
    assert not set(WAVE_METRICS) & {m.name for m in old.per_layer}


def test_generator_gives_the_amplicon_and_its_deleted_molecule():
    conf = spec.load_cell("long_pipeline").config
    assert sum(conf["exon_lens"]) == RCRS
    assert conf["exon_lens"][1] == DEL_LAST - DEL_FIRST + 1 == 4977
    iso, reads = generator.make_job(conf, 2 ** 31 + 77, 0, 40)
    assert [len(s) for s in iso] == [RCRS, RCRS, DELETED, DELETED]
    assert DELETED == 11592 and len(iso) == conf["isoforms"]
    assert conf["isoform_bases"] == [DELETED, RCRS]
    full, full_alt, deleted, deleted_alt = iso
    # the deleted molecule is the amplicon without rCRS 8,470-13,446
    assert deleted == full[:DEL_FIRST - 1] + full[DEL_LAST:]
    # each haplotype: three SNVs at 20, 50 and 80% of its molecule
    for ref, alt in ((full, full_alt), (deleted, deleted_alt)):
        diff = [p for p in range(len(ref)) if ref[p] != alt[p]]
        assert diff == [int(len(ref) * f) for f in conf["snv_fracs"]]
    # 0.2% noise, reads round-robin over the four molecules
    lens = np.array([len(r) for r in reads])
    want = np.array([len(iso[i % 4]) for i in range(40)])
    assert np.abs(lens - want).max() < 0.01 * want.max()
    assert sum(r != iso[i % 4] for i, r in enumerate(reads)) > 20


def _job(counters):
    return harness.Job(reads=500, seconds=7.0, phase_s={1: 4.0, 2: 3.0},
                       counters_phase1=None, counters_end=counters,
                       launches_phase1=None, launches_end={})


def _readers():
    return {name: spec.load_reader(name) for name in WAVE_METRICS}


def test_counter_readers_read_nothing_without_the_counters():
    """The parent's engine keeps neither counter: both readers give None,
    and wave_roofline gives None without a trace or a K5 kernel in it."""
    read = _readers()
    run = harness.Run(cell=None, seed=1)
    for name in WAVE_METRICS:
        assert read[name](run) is None, name
    run.jobs = [_job({"ed_pairs_wavefront": 40, "ed_wait_seconds": 0.5})]
    assert read["wave_wait_s"](run) is None
    assert read["wave_rerun_share"](run) is None
    run.recorder = Recorder(1, {})
    run.clock_mhz = 1980.0
    run.events, run.trace_spans = [_ev("user_annotation", "portbench.job",
                                       0, 100)], [(0, 100)]
    assert read["wave_roofline"](run) is None


def test_counter_readers_on_a_recorded_run():
    read = _readers()
    run = harness.Run(cell=None, seed=1)
    run.jobs = [
        _job({"ed_pairs_wavefront": 1200, "wave_pairs_rerun": 30,
              "wave_wait_seconds": 0.25, "ed_wait_seconds": 0.4}),
        _job({"ed_pairs_wavefront": 800, "wave_pairs_rerun": 10,
              "wave_wait_seconds": 0.15, "ed_wait_seconds": 0.3}),
    ]
    assert read["wave_wait_s"](run) == pytest.approx(0.2)
    assert read["wave_rerun_share"](run) == pytest.approx(100.0 * 40 / 2000)
    # K5 ran no pair: no share
    run.jobs = [_job({"ed_pairs_wavefront": 0, "wave_pairs_rerun": 0,
                      "wave_wait_seconds": 0.0})]
    assert read["wave_rerun_share"](run) is None
    assert read["wave_wait_s"](run) == 0.0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_wave_roofline_on_a_recorded_trace():
    """Only the distances past 16,384 bases count, over only the K5
    kernels inside the jobs' spans.  The K5 time is the kernel table's
    reading for a 16,384-pair chunk of 16.5-20 kb pairs at band 128 on one
    H100 (13.726 ms): with the NW distances a 0.2%-noise pair has, the
    share comes out a few percent, and far under 100%."""
    rng = np.random.default_rng(5)
    P = 16384
    la = rng.integers(16500, 17000, P)
    lb = la + rng.integers(-40, 40, P)
    ans = rng.integers(40, 90, P)
    caps = np.full(P, 2 ** 31 - 1)
    # short pairs (K1's) and an HW call of long pairs that gave up
    sa = rng.integers(11500, 11700, 1000)
    rec = Recorder(1, {}, keep_all=True)
    rec.ed_calls["ed_nw"] = [
        (la, lb, caps, ans),
        (sa, sa + 3, np.full(1000, 2 ** 31 - 1), np.full(1000, 60))]
    rec.ed_calls["ed_hw"] = [(la[:100], lb[:100] + 200, np.full(100, 50),
                              np.full(100, -1))]
    run = harness.Run(cell=None, seed=1)
    run.recorder, run.clock_mhz = rec, 1980.0
    k5_us = 13726.0
    k5 = "void (anonymous namespace)::wavefront_warp_kernel<2, %s>(...)"
    k1 = "void (anonymous namespace)::myers_band_kernel<7, 128, false>(...)"
    run.events = [
        _ev("user_annotation", "portbench.job", 0, 1e6),
        _ev("kernel", k5 % "false", 100, k5_us - 500),
        _ev("kernel", k5 % "true", 20000, 500),
        _ev("kernel", k1, 30000, 4000),
        # the benchmark's own work between jobs: outside the window
        _ev("kernel", k5 % "false", 2e6, 9000),
    ]
    run.trace_spans = [(0, 1e6)]
    o1, b1 = counts.ed_work(la, lb, ans, caps, hw=False)
    o2, b2 = counts.ed_work(la[:100], lb[:100] + 200, np.full(100, -1),
                            np.full(100, 50), hw=True)
    least, by = counts.bound_s(b1 + b2, o1 + o2, 1980.0)
    assert by == "operations"
    got = spec.load_reader("wave_roofline")(run)
    assert got == pytest.approx(100.0 * least / (k5_us * 1e-6))
    assert 0.5 < got < 10.0
