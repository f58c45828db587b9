"""Whole-mitochondrial-genome amplicons through the port: the benchmark's
``mtdna_hifi`` family (``portbench/configs/mtdna_hifi.json``: the amplicon,
its common-deletion molecule and a 3-SNV haplotype of each, 0.2% noise)
cut 32 times in length, 265 + 156 + 98 bases for 8,469 + 4,977 + 3,123.

The port's Myers limit is shrunk to 512 (as ``MYERS_MAX_L`` is 16,384 at
full length), so the full-length molecules' pairs land in the 1,024-wide
pool and run the banded wavefront (K5), and the deleted molecules' pairs
in the 512-wide pool on K1/K2, in one job, as the 16.6 and 11.6 kb reads
do on the card.  The port's plain kernels run (``ISOCON_NO_NATIVE=1``).

* ``pipeline``'s outputs equal the JAX package's byte for byte, and hold
  the four molecules;
* every distance and alignment the engine gave in that job equals the
  benchmark's plain reference (``portbench/reference.py``, loaded by its
  path);
* the long route's counters, ``wave_pairs_rerun`` and
  ``wave_wait_seconds``, on a hand-built batch.

Tolerance: exact.
"""
import importlib.util
import json
import os
import random

import pytest
import torch

from isocon_tpu_torch import cli as port_cli
from isocon_tpu_torch.ops import engine as port_engine
from isocon_tpu_torch.ops import oracle
from isocon_tpu_torch.ops.engine import PairEngine
from test_torch_native import plain_port_routes
from test_torch_pipeline import VOLUME, _assert_same_files, _run_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 19
READS = 32
EXONS = [265, 156, 98]
MYERS_MAX_L = 512


def _load(name):
    path = os.path.join(ROOT, "portbench", name + ".py")
    spec = importlib.util.spec_from_file_location("mtdna_test_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _family():
    """(molecules, reads) of the cut family, from the benchmark's own
    generator and configuration."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "mtdna_hifi.json")) as fh:
        conf = json.load(fh)
    assert [round(n / 32) for n in conf["exon_lens"]] == EXONS
    conf = dict(conf, exon_lens=EXONS)
    return _load("generator").make_job(conf, SEED, 0, READS)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its plain kernels and the
    reference run many small row ops, which other processes of a parallel
    test run slow hundreds of times over when torch spreads each op over
    every core (1.1 s alone, 249 s among six busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The cut family's reads through both packages' ``pipeline``; the
    port's every edit-distance and alignment answer recorded."""
    molecules, reads = _family()
    d = str(tmp_path_factory.mktemp("mtdna"))
    fasta = os.path.join(d, "reads.fa")
    with open(fasta, "w") as fh:
        fh.write("".join(">read_%d\n%s\n" % (i, s)
                         for i, s in enumerate(reads)))
    eds, alns = [], []
    ed_call, align_call = PairEngine.edit_distances, PairEngine.align_pairs

    def edit_distances(self, pairs, k_cap=None, hw_mode=False, **kw):
        ed, ej = ed_call(self, pairs, k_cap=k_cap, hw_mode=hw_mode, **kw)
        caps = [2 ** 31 - 1] * len(pairs) if k_cap is None else k_cap
        eds.extend((pairs[i][0], pairs[i][1], int(caps[i]), hw_mode,
                    int(ed[i]), int(ej[i])) for i in range(len(pairs)))
        return ed, ej

    def align_pairs(self, pairs, scores, **kw):
        out = align_call(self, pairs, scores, **kw)
        alns.extend((pairs[i][0], pairs[i][1], tuple(scores[i]), out[i])
                    for i in range(len(pairs)))
        return out

    with pytest.MonkeyPatch.context() as mp, plain_port_routes():
        mp.setattr(port_engine, "MYERS_MAX_L", MYERS_MAX_L)
        mp.setattr(PairEngine, "edit_distances", edit_distances)
        mp.setattr(PairEngine, "align_pairs", align_pairs)
        engine, _phase1 = port_cli.main(
            ["pipeline", "-fl_reads", fasta, "-outfolder",
             os.path.join(d, "torch"), "--device", "cpu"])
    jax_engine = _run_jax(["pipeline", "-fl_reads", fasta, "-outfolder",
                           os.path.join(d, "jax")])
    return {"dir": d, "molecules": molecules, "engine": engine,
            "jax_engine": jax_engine, "eds": eds, "alns": alns}


def test_mtdna_pipeline_byte_identical_and_recovers_every_molecule(job):
    molecules = job["molecules"]
    assert [len(s) for s in molecules] == [519, 519, 363, 363]
    assert molecules[2] == molecules[0][:265] + molecules[0][421:]
    want = _assert_same_files(os.path.join(job["dir"], "torch"),
                              os.path.join(job["dir"], "jax"))
    engine, jax_engine = job["engine"], job["jax_engine"]
    for key in VOLUME:
        assert engine.counters[key] == jax_engine.counters[key], key
    lines = want["final_candidates.fa"].decode().split("\n")
    assert sorted(lines[1::2][:len(molecules)]) == sorted(molecules)
    assert len([x for x in lines if x.startswith(">")]) == len(molecules)
    # both routes in one job: the full-length pairs on K5, the deleted
    # molecules' on K1 (NW) and K2 (HW)
    c = engine.counters
    assert 0 < c["ed_pairs_wavefront"] < c["ed_pairs"]
    assert {mode for mode, _w in engine.myers_rungs} == {"NW", "HW"}
    assert {mode for mode, _w in engine.wavefront_rungs} == {"NW", "HW"}
    assert c["wave_pairs_rerun"] == sum(
        n for (_mode, wp), n in engine.wavefront_rungs.items()
        if wp > port_engine.W0)
    assert 0 < c["wave_wait_seconds"] < c["ed_wait_seconds"]


def test_mtdna_engine_answers_equal_the_reference(job):
    """Each distance is the reference's where it is within the caller's
    cap, else -1; an HW answer's end is a column where the query's last
    DP row holds it; each alignment is one of its two sequences, scores
    the reference's optimum and carries its own counts."""
    reference = _load("reference")
    for hw in (False, True):
        calls = [e for e in job["eds"] if e[3] == hw]
        assert calls
        dist, rows = reference.edit_distances([(a, b) for a, b, *_ in calls],
                                              hw, "cpu")
        for k, (a, b, cap, _hw, ed, ej) in enumerate(calls):
            assert ed == (int(dist[k]) if dist[k] <= cap else -1)
            if hw and ed >= 0:
                assert 0 <= ej <= len(b) and int(rows[k][ej]) == ed
    alns = job["alns"]
    assert alns
    best = reference.semi_global_scores([(a, b) for a, b, _s, _r in alns],
                                        [s for _a, _b, s, _r in alns], "cpu")
    for k, (a, b, score, (a1, a2, counts)) in enumerate(alns):
        got = reference.alignment_score(a1, a2, a, b, score)
        assert got is not None and got[0] == int(best[k])
        assert tuple(int(x) for x in counts) == got[1]


def _wave_batch():
    """Pairs of 180-250 bases (the 256-wide pool): near copies, which
    certify at band 128, and copies with a 70-90 base gap, outside band
    128's diagonals, which run again at band 256."""
    rng = random.Random(11)
    near, gapped = [], []
    for k in range(8):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randrange(180, 250)))
        if k % 2:
            cut = rng.randrange(70, 90)
            gapped.append((a, a[:40] + a[40 + cut:]))
        else:
            b = list(a)
            for p in rng.sample(range(len(a)), 5):
                b[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[b[p]]
            near.append((a, "".join(b)))
    return near, gapped


def test_wave_counters_on_a_hand_built_batch(monkeypatch):
    """Every pair runs K5 once at band 128; only the gapped pairs run
    again, at 256, and count as reruns.  Every collect is K5's, so its
    wait is the whole of ``ed_wait_seconds``.  K1's batches add to
    neither counter."""
    monkeypatch.setenv("ISOCON_NO_NATIVE", "1")
    near, gapped = _wave_batch()
    pairs = near + gapped
    monkeypatch.setattr(port_engine, "MYERS_MAX_L", 128)
    eng = PairEngine(device="cpu")
    got, _ = eng.edit_distances(pairs)
    assert got.tolist() == [oracle.edit_distance(a, b) for a, b in pairs]
    c = eng.counters
    assert eng.wavefront_rungs == {("NW", 128): len(pairs),
                                   ("NW", 256): len(gapped)}
    assert c["ed_pairs_wavefront"] == len(pairs) + len(gapped)
    assert c["wave_pairs_rerun"] == len(gapped)
    assert 0 < c["wave_wait_seconds"] == c["ed_wait_seconds"]
    assert "%d of them reruns" % len(gapped) in eng.stats_line()
    # HW, the gapped copy as the query: its distance lies past band 128's
    # certified radius, so it runs again at 256 too
    hw = [(b, a) for a, b in gapped] + near
    got, _ = eng.edit_distances(hw, hw_mode=True)
    assert got.tolist() == [oracle.edit_distance_hw(a, b)[0] for a, b in hw]
    assert eng.wavefront_rungs[("HW", 256)] == len(gapped)
    assert c["wave_pairs_rerun"] == 2 * len(gapped)
    assert c["wave_wait_seconds"] == c["ed_wait_seconds"]
    monkeypatch.setattr(port_engine, "MYERS_MAX_L", 16384)
    k1 = PairEngine(device="cpu")
    k1.edit_distances(pairs)
    assert k1.counters["ed_wait_seconds"] > 0
    assert k1.counters["wave_wait_seconds"] == 0
    assert k1.counters["ed_pairs_wavefront"] == 0
    assert k1.counters["wave_pairs_rerun"] == 0
