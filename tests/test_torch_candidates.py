"""Phase-1 slice: the port's ``find_candidate_transcripts`` (plain kernels
on the CPU) vs the JAX package's on the same reads and parameters.

Three isoforms (a base, an exon-skip variant, a 3-SNV haplotype) x 12
noisy reads of 300-500 bp, from the generator of test_pipeline_e2e.py.
``candidates_converged.fa`` and every ``candidates_step_*.fa`` must be
byte-identical, and so must the NN tie sets of the first iteration and
the number of pairs of every ED and alignment call the pipeline makes.
"""
import glob
import os
import random

import numpy as np
import pytest

from isocon_tpu.graph.nn import nearest_neighbors as jax_nn
from isocon_tpu.ops.engine import PairEngine as JaxEngine
from isocon_tpu.params import Params as JaxParams
from isocon_tpu.pipeline.candidates import (
    find_candidate_transcripts as jax_find)
from isocon_tpu_torch.cli import build_parser
from isocon_tpu_torch.graph.nn import nearest_neighbors
from isocon_tpu_torch.io import read_fasta
from isocon_tpu_torch.ops.engine import PairEngine
from isocon_tpu_torch.params import Params
from isocon_tpu_torch.pipeline.candidates import find_candidate_transcripts
from test_torch_native import plain_port_routes


@pytest.fixture(scope="module", autouse=True)
def _plain_port_routes():
    """The port's engines in this file keep the plain K1/K2/K5 on the CPU
    (``ISOCON_NO_NATIVE=1``); ``tests/test_torch_native.py`` holds the
    host route."""
    with plain_port_routes():
        yield


def rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def noisy_copy(rng, s, error_rate):
    out = []
    for ch in s:
        r = rng.random()
        if r < error_rate * 0.4:        # substitution
            out.append(rng.choice([c for c in "ACGT" if c != ch]))
        elif r < error_rate * 0.7:      # insertion
            out.append(ch)
            out.append(rng.choice("ACGT"))
        elif r < error_rate:            # deletion
            pass
        else:
            out.append(ch)
    return "".join(out)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    rng = random.Random(7)
    base = rand_seq(rng, 480)
    skip = base[:160] + base[300:]
    bl = list(base)
    for pos in (60, 200, 380):
        bl[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bl[pos]]
    isoforms = [base, skip, "".join(bl)]
    d = str(tmp_path_factory.mktemp("slice"))
    path = os.path.join(d, "reads.fa")
    with open(path, "w") as fh:
        for k, iso in enumerate(isoforms):
            for i in range(12):
                fh.write(">read_%d_%d\n%s\n" % (k, i,
                                               noisy_copy(rng, iso, 0.02)))
    return path, d


def _params(cls, path, out, extra=()):
    ns = build_parser().parse_args(
        ["get_candidates", "-fl_reads", path, "-outfolder", out, *extra])
    fields = {k: v for k, v in vars(ns).items() if k != "which"}
    if cls is JaxParams:
        fields.pop("device")
    p = cls(**fields, is_fastq=False)
    p.ensure_outfolder()
    return p


def _files(out):
    return {os.path.basename(f): open(f, "rb").read()
            for f in sorted(glob.glob(os.path.join(out, "*.fa")))}


def _recording(engine):
    """Record len(pairs) of every ED and alignment call of ``engine``."""
    calls = []
    for name in ("edit_distances", "align_pairs"):
        fn = getattr(engine, name)

        def counted(pairs, *args, _fn=fn, _name=name, **kw):
            calls.append((_name, len(pairs)))
            return _fn(pairs, *args, **kw)

        setattr(engine, name, counted)
    return engine, calls


def test_candidates_byte_identical(reads):
    path, d = reads
    out_j = os.path.join(d, "jax")
    out_t = os.path.join(d, "torch")
    jax_engine, want_calls = _recording(JaxEngine())
    jax_find(path, _params(JaxParams, path, out_j), jax_engine)
    engine, got_calls = _recording(PairEngine(device="cpu"))
    find_candidate_transcripts(
        path, _params(Params, path, out_t, ["--device", "cpu"]), engine)
    assert got_calls == want_calls
    for key in ("ed_calls", "ed_pairs", "align_calls", "align_pairs"):
        assert engine.counters[key] == jax_engine.counters[key], key
    want = _files(out_j)
    got = _files(out_t)
    assert "candidates_converged.fa" in want
    assert any(k.startswith("candidates_step_") for k in want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert engine.counters["ed_pairs"] > 0
    assert engine.counters["align_pairs"] > 0


def test_first_iteration_nn_tie_sets(reads):
    path, _d = reads
    seqs = sorted({s for _a, s in read_fasta(path)})
    conv = [False] * len(seqs)
    want = jax_nn(seqs, conv, JaxEngine())
    got = nearest_neighbors(seqs, conv, PairEngine(device="cpu"))
    assert got == want
    assert sum(len(x) for x in got) >= len(seqs)
    assert np.mean([len(x) for x in got]) >= 1
