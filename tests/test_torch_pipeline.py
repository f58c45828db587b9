"""The slice as a whole: the port's ``pipeline`` and ``stat_filter``
subcommands (plain kernels on the CPU, and once the CLI's default CPU
route, the host C++ edit distances) vs the JAX package's on the same
reads.

Four isoforms (a base, a 3-SNV haplotype, a 1-SNV haplotype with few reads
and an exon-skip variant) x noisy reads of ~300 bp, as fasta, as fastq and
as fasta with a ``--ccs`` BAM.  ``final_candidates.fa``,
``cluster_info.tsv``, ``candidates_converged.fa``, every
``p_values_*.tsv`` and every ``candidates_after_step_*.fa`` must be
byte-identical, and the engines must have made the same number of ED and
alignment calls over the same number of pairs.  The crossed runs hold each
phase to the reference alone: each package's ``stat_filter`` runs on the
other's ``candidates_converged.fa``.  Tolerance: exact.
"""
import glob
import os
import random

import pytest

from isocon_tpu import cli as jax_cli
from isocon_tpu_torch import cli as port_cli
from isocon_tpu_torch.io.bam import read_ccs_bam, write_bam
from isocon_tpu_torch.io.ccs import reverse_complement
from isocon_tpu_torch.ops.engine import PairEngine
from test_torch_candidates import noisy_copy, rand_seq
from test_torch_native import plain_port_routes


@pytest.fixture(scope="module", autouse=True)
def _plain_port_routes():
    """The port's engines in this file keep the plain K1/K2/K5 on the CPU
    (``ISOCON_NO_NATIVE=1``); ``tests/test_torch_native.py`` holds the
    host route."""
    with plain_port_routes():
        yield

COMPARED = ("final_candidates.fa", "cluster_info.tsv",
            "candidates_converged.fa", "p_values_*.tsv",
            "candidates_after_step_*.fa")
VOLUME = ("ed_calls", "ed_pairs", "align_calls", "align_pairs")


def _snv(seq, positions):
    s = list(seq)
    for pos in positions:
        s[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[s[pos]]
    return "".join(s)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """reads.fa, reads.fq and ccs.bam of the same seeded reads."""
    rng = random.Random(17)
    base = rand_seq(rng, 320)
    isoforms = [(base, 22), (_snv(base, (50, 140, 260)), 18),
                (_snv(base, (200,)), 5),
                (base[:110] + base[170:], 14)]
    reads = []
    zmw = 100
    for iso, count in isoforms:
        for _ in range(count):
            seq = noisy_copy(rng, iso, 0.02)
            strand = "+" if zmw % 2 == 0 else "-"
            acc = "m1/%d/0_%d_CCS strand=%s;fiveseen=1" % (zmw, len(seq),
                                                           strand)
            qual = [rng.randrange(20, 80) for _ in seq]
            reads.append((acc, seq, qual, strand))
            zmw += 1
    d = str(tmp_path_factory.mktemp("pipeline"))
    fa = os.path.join(d, "reads.fa")
    fq = os.path.join(d, "reads.fq")
    with open(fa, "w") as fh:
        for acc, seq, _q, _s in reads:
            fh.write(">%s\n%s\n" % (acc, seq))
    with open(fq, "w") as fh:
        for acc, seq, qual, _s in reads:
            fh.write("@%s\n%s\n+\n%s\n" % (
                acc, seq, "".join(chr(33 + min(q, 60)) for q in qual)))
    # ccs.bam: the full ccs reads, 3 bp longer at both ends; strand=- reads
    # are stored reverse-complemented
    records = []
    for acc, seq, qual, strand in reads:
        ccs_seq = "ACG" + seq + "TTA"
        ccs_qual = [30, 30, 30] + qual + [30, 30, 30]
        if strand == "-":
            ccs_seq = reverse_complement(ccs_seq)
            ccs_qual = ccs_qual[::-1]
        name = "/".join(acc.split(" ")[0].split("/")[:2]) + "/ccs"
        records.append((name, ccs_seq, ccs_qual, {"np": 10}))
    bam = os.path.join(d, "ccs.bam")
    write_bam(bam, records)
    return {"dir": d, "fasta": [fa], "fastq": [fq],
            "bam": [fa, "--ccs", bam], "n_reads": len(reads)}


def _run_jax(argv):
    """The JAX package's CLI; returns its engine."""
    engines = []
    make_engine = jax_cli.make_engine

    def recording(params):
        engines.append(make_engine(params))
        return engines[-1]

    jax_cli.make_engine = recording
    try:
        jax_cli.main(argv)
    finally:
        jax_cli.make_engine = make_engine
    (engine,) = engines
    return engine


def _files(out):
    found = {}
    for pattern in COMPARED:
        for f in sorted(glob.glob(os.path.join(out, pattern))):
            with open(f, "rb") as fh:
                found[os.path.basename(f)] = fh.read()
    return found


def _assert_same_files(got_dir, want_dir, converged=True):
    want = _files(want_dir)
    got = _files(got_dir)
    assert "final_candidates.fa" in want and "cluster_info.tsv" in want
    assert ("candidates_converged.fa" in want) == converged
    assert any(k.startswith("p_values_") for k in want)
    assert any(k.startswith("candidates_after_step_") for k in want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert want["final_candidates.fa"].count(b">") >= 2
    return want


@pytest.fixture(scope="module")
def runs(inputs):
    """Both packages' ``pipeline`` on each input form, run once."""
    done = {}

    def run(form):
        if form not in done:
            out_j = os.path.join(inputs["dir"], form + "_jax")
            out_t = os.path.join(inputs["dir"], form + "_torch")
            reads, extra = inputs[form][0], inputs[form][1:]
            jax_engine = _run_jax(["pipeline", "-fl_reads", reads,
                                   "-outfolder", out_j, *extra])
            engine, phase1 = port_cli.main(
                ["pipeline", "-fl_reads", reads, "-outfolder", out_t,
                 "--device", "cpu", *extra])
            done[form] = (out_j, out_t, jax_engine, engine, phase1)
        return done[form]

    return run


@pytest.mark.parametrize("form", ["fasta", "fastq", "bam"])
def test_pipeline_byte_identical(inputs, runs, form):
    out_j, out_t, jax_engine, engine, phase1 = runs(form)
    want = _assert_same_files(out_t, out_j)
    rows = want["cluster_info.tsv"].decode().splitlines()
    assert 0 < len(rows) <= inputs["n_reads"]
    for key in VOLUME:
        assert engine.counters[key] == jax_engine.counters[key], key
        assert 0 < phase1[key] < engine.counters[key], key
    # phase 2 ran the HW prefilter and the host traceback
    assert engine.counters["hw_survivors"] > 0


def test_pipeline_byte_identical_on_the_long_bucket_route(inputs, runs,
                                                         monkeypatch):
    """The same reads once more with the port's Myers limit shrunk below
    their pool width (512), so every edit distance of both phases runs the
    banded wavefront, NW and HW: the outputs stay byte-identical to the
    JAX package's."""
    from isocon_tpu_torch.ops import engine as port_engine

    monkeypatch.setattr(port_engine, "MYERS_MAX_L", 256)
    out_j, _out_t, jax_engine, _engine, _phase1 = runs("fasta")
    out_w = os.path.join(inputs["dir"], "fasta_torch_wavefront")
    engine, phase1 = port_cli.main(
        ["pipeline", "-fl_reads", inputs["fasta"][0], "-outfolder", out_w,
         "--device", "cpu"])
    _assert_same_files(out_w, out_j)
    for key in VOLUME:
        assert engine.counters[key] == jax_engine.counters[key], key
    assert 0 < phase1["ed_pairs_wavefront"] < engine.counters[
        "ed_pairs_wavefront"]
    assert engine.counters["ed_pairs_full_window"] == 0
    assert {mode for mode, _wp in engine.wavefront_rungs} == {"NW", "HW"}


def test_pipeline_byte_identical_on_the_native_route(inputs, runs,
                                                     monkeypatch):
    """The CLI's default CPU run, unpinned: its engine takes the host C++
    route for every edit distance (``native_cpu``), as its users get it,
    and the outputs stay byte-identical to the JAX package's
    ``--devices 1`` run, with the same ED and alignment volume."""
    from isocon_tpu_torch import native

    monkeypatch.setattr(PairEngine, "__init__",
                        PairEngine.__init__.__wrapped__)
    monkeypatch.delenv("ISOCON_NO_NATIVE", raising=False)
    host_calls = []
    myers_ed_batch_k = native.myers_ed_batch_k

    def counted(*args):
        host_calls.append(len(args[0]))
        return myers_ed_batch_k(*args)

    monkeypatch.setattr(native, "myers_ed_batch_k", counted)
    out_j, _out_t, jax_engine, _engine, _phase1 = runs("fasta")
    out_n = os.path.join(inputs["dir"], "fasta_torch_native")
    engine, _phase1 = port_cli.main(
        ["pipeline", "-fl_reads", inputs["fasta"][0], "-outfolder", out_n,
         "--device", "cpu"])
    assert engine.native_cpu and jax_engine.native_cpu
    assert sum(host_calls) > 0
    _assert_same_files(out_n, out_j)
    for key in VOLUME:
        assert engine.counters[key] == jax_engine.counters[key], key
    assert engine.counters["ed_pairs_full_window"] == 0
    assert engine.counters["hw_survivors"] > 0


def test_ccs_bam_changes_the_p_values(runs):
    """The BAM's quality values reach the test: other p-values than the
    empirical error rates of the plain fasta run give."""
    fa = _files(runs("fasta")[1])
    bam = _files(runs("bam")[1])
    assert fa["p_values_1.tsv"] != bam["p_values_1.tsv"]


def test_bam_roundtrip(inputs):
    ccs = read_ccs_bam(inputs["bam"][2])
    assert len(ccs) == inputs["n_reads"]
    assert all(len(c.seq) == len(c.qual) for c in ccs.values())


def _stat_filter(main, cands, reads, out, extra=()):
    return main(["stat_filter", "-fl_reads", reads, "-candidates", cands,
                 "-outfolder", out, *extra])


def test_port_stat_filter_on_jax_candidates(inputs, runs):
    out_j, _out_t, _je, _e, _p = runs("fasta")
    cands = os.path.join(out_j, "candidates_converged.fa")
    reads = inputs["fasta"][0]
    want_dir = os.path.join(inputs["dir"], "sf_jax_on_jax")
    got_dir = os.path.join(inputs["dir"], "sf_torch_on_jax")
    jax_engine = _run_jax(["stat_filter", "-fl_reads", reads, "-candidates",
                           cands, "-outfolder", want_dir])
    engine = _stat_filter(port_cli.main, cands, reads, got_dir,
                          ["--device", "cpu"])
    _assert_same_files(got_dir, want_dir, converged=False)
    for key in VOLUME:
        assert engine.counters[key] == jax_engine.counters[key], key


def test_jax_stat_filter_on_port_candidates(inputs, runs):
    _out_j, out_t, _je, _e, _p = runs("fasta")
    cands = os.path.join(out_t, "candidates_converged.fa")
    reads = inputs["fasta"][0]
    want_dir = os.path.join(inputs["dir"], "sf_jax_on_torch")
    got_dir = os.path.join(inputs["dir"], "sf_torch_on_torch")
    _run_jax(["stat_filter", "-fl_reads", reads, "-candidates", cands,
              "-outfolder", want_dir])
    _stat_filter(port_cli.main, cands, reads, got_dir, ["--device", "cpu"])
    _assert_same_files(got_dir, want_dir, converged=False)


@pytest.mark.parametrize("which", ["pipeline", "stat_filter",
                                   "get_candidates"])
def test_subcommand_defaults_to_cuda(inputs, which, tmp_path):
    """Without a card and without --device cpu every subcommand raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [which, "-fl_reads", inputs["fasta"][0], "-outfolder",
            str(tmp_path / "out")]
    if which == "stat_filter":
        argv += ["-candidates", inputs["fasta"][0]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(argv)
