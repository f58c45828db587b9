"""A run of a cell at a small size on the CPU, with the timed path whole
and broken underneath: the control and each fault of the engine's
answers must turn ``correct`` false through the numbers the comparison
reads, and a job's outputs altered where they are written must show in
the outputs' numbers."""
import contextlib
import time

import pytest

from portbench import faults, harness, spec

# which number each break must move
MOVES = {
    "control": ("ed_nw_wrong", "ed_hw_wrong"),
    "ed_altered": ("ed_nw_wrong",),
    "ed_half": ("ed_nw_wrong",),
    "align_altered": ("align_wrong",),
}
NUMBERS = ("ed_nw_wrong", "ed_hw_wrong", "align_wrong", "cluster_errors",
           "jobs_failed", "isoforms_missed", "candidates_extra")

# the breaks of the engine's answers need the full family's many capped
# pairs; the whole path and the break of its outputs, a family small
# enough that 80 reads recover every isoform
COMBOS = {"output_altered": 2, None: 2}


def _small_cell(combos=None):
    """targeted_pipeline at 30% of its exon lengths and 80 reads a job,
    with its first ``combos`` exon combinations (default all)."""
    cell = spec.load_cell("targeted_pipeline")
    conf = cell.config
    cell.config = dict(conf, reads_per_job=80,
                       combos=conf["combos"][:combos],
                       exon_lens=[int(x * 0.3) for x in conf["exon_lens"]])
    cell.checks = dict(cell.checks,
                       sample={"ed_nw": 400, "ed_hw": 200, "align": 100})
    return cell


def _run(mode):
    ctx = (contextlib.nullcontext() if mode is None
           else faults.fault(mode))
    with ctx:
        return harness.run_cell(_small_cell(COMBOS.get(mode)), 2 ** 31 + 9,
                                0, False,
                                time.time(), device="cpu",
                                log=lambda msg: None)


def test_whole_path_reads_no_wrong_answer():
    res = _run(None)
    assert res["attempted"] == 1 and res["failed"] == 0
    for name in NUMBERS:
        assert res["checks"][name]["value"] == 0, name
    assert res["correct"] is True


@pytest.mark.parametrize("mode", sorted(MOVES))
def test_break_turns_correct_false(mode):
    res = _run(mode)
    assert res["correct"] is False
    for name in MOVES[mode]:
        assert res["checks"][name]["value"] > 0, name


def test_output_break_moves_the_outputs_numbers():
    """The outputs' numbers have limits over a window of about ten jobs
    (their readings at the cell's size are in PERF.md); one job with its
    outputs broken reads 1 on each."""
    res = _run("output_altered")
    assert res["attempted"] == 1 and res["failed"] == 0
    assert res["checks"]["isoforms_missed"]["value"] == 1
    assert res["checks"]["candidates_extra"]["value"] == 1
