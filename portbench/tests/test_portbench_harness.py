"""The harness's own arithmetic and discovery, on the CPU."""
import json
import os
import shutil

import numpy as np
import pytest

from portbench import counts, generator, harness, spec, trace

BENCH = os.path.join(spec.ROOT, "BENCHMARK.json")


def test_benchmark_cells_load():
    bench = spec.load_json(BENCH)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert {m.name for m in cell.end_to_end} >= {"reads_per_s",
                                                     "setup_s"}
        assert cell.per_layer
        assert set(cell.checks["limits"]) >= {
            "ed_nw_wrong", "ed_hw_wrong", "align_wrong", "jobs_failed",
            "cluster_errors", "isoforms_missed", "candidates_extra"}


def test_new_cell_and_metric_from_added_files(tmp_path):
    """A cell and a per-layer metric added as files and entries alone are
    found by name, and the metric's reader runs."""
    root = tmp_path / "repo"
    bench_dir = root / "portbench"
    shutil.copytree(spec.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_json(BENCH)
    bench["workloads"].append({
        "name": "targeted_candidates", "config": "targeted_ccs",
        "traffic": "candidates_jobs", "chips": 1,
        "why": "get_candidates only"})
    bench["per_layer"].append({
        "name": "jobs_done", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "pipeline phases",
        "moves": "reads_per_s", "workloads": ["targeted_candidates"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((bench_dir / "traffic" / "pipeline_jobs.json")
                         .read_text())
    traffic.update(name="candidates_jobs", subcommand="get_candidates")
    (bench_dir / "traffic" / "candidates_jobs.json").write_text(
        json.dumps(traffic))
    shutil.copy(bench_dir / "checks" / "targeted_pipeline.json",
                bench_dir / "checks" / "targeted_candidates.json")
    (bench_dir / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return len(run.jobs) or None\n")

    cell = spec.load_cell("targeted_candidates", root=str(root),
                          bench_dir=str(bench_dir))
    assert cell.traffic["subcommand"] == "get_candidates"
    names = [m.name for m in cell.per_layer]
    assert names == ["jobs_done"]
    run = harness.Run(cell=cell, seed=1)
    assert spec.metric_values(cell.per_layer, run) == {}
    run.jobs = [object(), object()]
    assert spec.metric_values(cell.per_layer, run) == {
        "jobs_done": {"value": 2, "unit": "jobs"}}
    # the existing cell does not report the new cell's metric
    old = spec.load_cell("targeted_pipeline", root=str(root),
                         bench_dir=str(bench_dir))
    assert "jobs_done" not in [m.name for m in old.per_layer]


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["isocon_tpu_torch", "isocon_tpu_torch.ops.engine", "jaxtyping",
            "numpy", "flaxen", "isocon_tpu_tools"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax", "jax.numpy", "jaxlib",
                                             "flax.linen", "isocon_tpu",
                                             "isocon_tpu.ops"]) == [
        "flax.linen", "isocon_tpu", "isocon_tpu.ops", "jax", "jax.numpy",
        "jaxlib"]


def test_ed_work_hand_counts():
    # NW, answer 10: 11 rows = 1 word a column, 1,000 columns
    ops, nbytes = counts.ed_work([1000], [1000], [10], [2 ** 31 - 1],
                                 hw=False)
    assert ops == 1 * 1000 * 8
    assert nbytes == 1000 + 1000 + 16 + 4
    # NW, answer 140: 141 rows = 5 words; HW, answer 40: 81 rows = 3 words
    assert counts.ed_work([500], [600], [140], [199], hw=False)[0] == \
        5 * 600 * 8
    assert counts.ed_work([500], [600], [40], [99], hw=True)[0] == \
        3 * 600 * 8
    # above the cap: the cap's rows; NW pairs past their cap by length,
    # and empty ones, need nothing
    assert counts.ed_work([100], [100], [-1], [63], hw=False)[0] == \
        2 * 100 * 8
    assert counts.ed_work([100, 0], [300, 5], [-1, 5], [63, 9],
                          hw=False)[0] == 0
    # the band never exceeds the query
    assert counts.ed_work([20], [900], [-1], [2 ** 31 - 1],
                          hw=True)[0] == 1 * 900 * 8


def test_align_work_hand_counts():
    # aligned columns 2, 5 and 7; gaps at 3, 4 and 6 between them
    assert counts.aligned_span("--AC-GTA", "TTA-CG-A") == (3, 6)
    assert counts.aligned_span("AC--", "--GT") == (0, 0)
    ops, nbytes = counts.align_work([100], [120], [3], [104])
    # 219 anti-diagonals of 2 band cells, 2 a diagonal, 16 a step
    assert ops == 219 * 2 * 20 + 219 * 2 + 104 * 16
    assert nbytes == 220 + 44 + 219 * 2 + 2 * 104


def test_bound_is_the_larger_term():
    secs, by = counts.bound_s(0.0, 132 * 64 * 1980e6, 1980.0)
    assert by == "operations" and secs == pytest.approx(1.0)
    secs, by = counts.bound_s(3.35e12, 1.0, 1980.0)
    assert by == "bytes" and secs == pytest.approx(1.0)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_and_idle_share_on_a_recorded_trace(tmp_path):
    events = [
        _ev("user_annotation", "portbench.job", 0, 1000),
        _ev("user_annotation", "isocon_phase1", 0, 600),
        _ev("user_annotation", "portbench.ed_nw", 100, 200),
        _ev("user_annotation", "isocon_phase2", 600, 400),
        _ev("kernel", "void myers_band_kernel<7>(...)", 150, 100),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 200, 100),
        _ev("kernel", "void affine_walk_kernel(...)", 700, 50),
        _ev("gpu_memset", "Memset (Device)", 720, 10),
        _ev("cuda_runtime", "cudaStreamSynchronize", 300, 5),
        # the benchmark's own work between two jobs: outside the window
        _ev("kernel", "void myers_band_kernel<7>(...)", 1100, 300),
        _ev("user_annotation", "portbench.job", 1500, 500),
        _ev("kernel", "void myers_band_kernel<7>(...)", 1900, 50),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    loaded = trace.load_events(str(path))
    spans = trace.spans_of(loaded, "portbench.job")
    assert spans == [(0, 1000), (1500, 2000)]
    inside = trace.within(loaded, spans)
    dev = trace.device_events(inside)
    # [150, 300), [700, 750) and [1900, 1950): 250 us busy
    assert trace.busy_seconds(dev) == pytest.approx(250e-6)
    assert trace.kernel_seconds(inside, ("myers_",)) == pytest.approx(1.5e-4)
    gaps = dict(trace.idle_gaps(loaded, spans))
    # [0, 150) phase 1 (middle 75, outside the ED span); [300, 700) middle
    # 500 in phase 1; [750, 1000) in phase 2; [1500, 1900) and
    # [1950, 2000) in the second job
    assert gaps == pytest.approx({"isocon_phase1": 550e-6,
                                  "isocon_phase2": 250e-6,
                                  "portbench.job": 450e-6})
    ops = dict(trace.device_ops(inside))
    assert ops["void myers_band_kernel<7>(...)"] == pytest.approx(1.5e-4)
    assert trace.summarise(inside)["host: cudaStreamSynchronize"] == {
        "count": 1, "s": 5e-6}
    cell = spec.load_cell("targeted_pipeline")
    run = harness.Run(cell=cell, seed=0)
    run.events, run.trace_spans, run.busy_s = loaded, spans, 250e-6
    assert run.trace_s == pytest.approx(1500e-6)
    read = spec.load_reader("device_idle_share")
    assert read(run) == pytest.approx(100.0 * (1 - 250 / 1500))


def test_generator_is_seeded_and_sized_alike():
    conf = spec.load_cell("targeted_pipeline").config
    iso1, reads1 = generator.make_job(conf, 2 ** 31 + 5, 3, 200)
    iso2, reads2 = generator.make_job(conf, 2 ** 31 + 5, 3, 200)
    assert (iso1, reads1) == (iso2, reads2)
    iso3, reads3 = generator.make_job(conf, 2 ** 31 + 5, 4, 200)
    assert iso3 != iso1
    # every seed and job: the same isoform lengths
    assert [len(s) for s in iso1] == [len(s) for s in iso3]
    assert len(iso1) == conf["isoforms"] == 26
    lo, hi = conf["isoform_bases"]
    assert lo <= min(map(len, iso1)) and max(map(len, iso1)) <= hi
    # about 1% noise, and round-robin over the isoforms
    lens = np.array([len(r) for r in reads1])
    want = np.array([len(iso1[i % 26]) for i in range(200)])
    assert abs(lens.mean() - want.mean()) < 5
    assert set("".join(reads1)) <= set("ACGT")
