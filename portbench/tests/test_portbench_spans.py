"""``spans.py``'s self times and the readers that use it, on hand-made
event lists (times in us)."""
import pytest

from portbench import harness, spans, spec


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


JOB = [(0, 1000)]


def test_overlapping_children_are_counted_once():
    events = [
        _ev("portbench.job", 0, 1000),
        _ev("isocon_phase1", 0, 900),
        _ev("isocon_phase1.align", 100, 500),
        _ev("isocon_engine.align", 150, 100),
        _ev("isocon_engine.ed_nw", 200, 100),     # overlaps the one above
        _ev("isocon_engine.ed_nw", 400, 50),
    ]
    # 500 less the union [150, 300) and [400, 450)
    assert spans.self_seconds(events, "isocon_phase1.align",
                              JOB) == pytest.approx(300e-6)


def test_recorder_span_around_an_engine_span_counts_once():
    events = [
        _ev("portbench.job", 0, 1000),
        _ev("isocon_phase2.tests", 100, 600),
        _ev("portbench.align", 200, 300),
        _ev("isocon_engine.align", 210, 250),
        # the device's copy of an annotation is no host span
        _ev("isocon_engine.align", 100, 600, cat="gpu_user_annotation"),
        # a layer span nested in the layer is no child
        _ev("isocon_phase2.assign", 550, 100),
    ]
    assert spans.self_seconds(events, "isocon_phase2.tests",
                              JOB) == pytest.approx(300e-6)


def test_spans_outside_the_window_are_clipped_or_left_out():
    events = [
        _ev("portbench.job", 0, 1000),
        _ev("portbench.job", 2000, 1000),
        # ends after its job: clipped to [800, 1000), its child to
        # [900, 1000)
        _ev("isocon_phase1.correct", 800, 400),
        _ev("isocon_engine.align", 900, 200),
        # between the jobs: outside the window
        _ev("isocon_phase1.correct", 1200, 300),
        _ev("isocon_phase1.correct", 2100, 100),
    ]
    windows = [(0, 1000), (2000, 3000)]
    assert spans.self_seconds(events, "isocon_phase1.correct",
                              windows) == pytest.approx(200e-6)
    assert spans.self_seconds(events, "isocon_phase1.nn_graph",
                              windows) is None


def test_readers_are_silent_without_the_program_s_spans_and_counters():
    cell = spec.load_cell("targeted_pipeline")
    run = harness.Run(cell=cell, seed=0)
    names = ("nn_graph_host_s", "partition_s", "star_align_host_s",
             "correct_s", "static_graph_host_s", "assign_host_s",
             "stat_tests_host_s", "engine_wait_s", "align_decode_s",
             "engine_host_s", "fetch_mib", "upload_mib")
    assert {m.name for m in cell.per_layer} >= set(names)
    readers = {n: spec.load_reader(n) for n in names}
    assert all(r(run) is None for r in readers.values())
    # a parent's trace and counters: the phases and no layer spans
    run.events = [_ev("portbench.job", 0, 1000),
                  _ev("isocon_phase1", 0, 600)]
    run.trace_spans = JOB
    old = {"ed_seconds": 1.0, "align_seconds": 2.0}
    run.jobs = [harness.Job(10, 1.0, {1: 0.6}, old, old, None, {})]
    assert all(r(run) is None for r in readers.values())


def test_readers_split_the_engine_and_average_over_jobs():
    cell = spec.load_cell("targeted_pipeline")
    run = harness.Run(cell=cell, seed=0)
    run.events = [
        _ev("portbench.job", 0, 1000),
        _ev("isocon_phase1.nn_graph", 0, 400),
        _ev("portbench.ed_nw", 100, 100),
        _ev("portbench.job", 2000, 1000),
        _ev("isocon_phase1.nn_graph", 2000, 200),
    ]
    run.trace_spans = [(0, 1000), (2000, 3000)]
    assert spec.load_reader("nn_graph_host_s")(run) == pytest.approx(
        (300e-6 + 200e-6) / 2)

    def counters(k):
        return {"ed_seconds": 1.0 * k, "align_seconds": 3.0 * k,
                "ed_wait_seconds": 0.25 * k, "align_wait_seconds": 0.5 * k,
                "align_decode_seconds": 1.0 * k,
                "fetch_bytes": 2 ** 20 * k, "upload_bytes": 2 ** 21 * k}

    run.jobs = [harness.Job(10, 1.0, {}, None, counters(k), None, {})
                for k in (1, 3)]
    got = {n: spec.load_reader(n)(run) for n in (
        "engine_wait_s", "align_decode_s", "engine_host_s", "fetch_mib",
        "upload_mib", "engine_s")}
    assert got == pytest.approx({
        "engine_wait_s": 1.5, "align_decode_s": 2.0, "engine_host_s": 4.5,
        "fetch_mib": 2.0, "upload_mib": 4.0, "engine_s": 8.0})
    assert (got["engine_wait_s"] + got["align_decode_s"]
            + got["engine_host_s"]) == pytest.approx(got["engine_s"])
