"""The port's sharded engine, pipeline, multi-process seam and
``make_engine`` against the port's unsharded runs and the JAX package's
``parallel/`` (on the 8 virtual CPU devices of conftest.py).

On the CPU a mesh is n logical shards of ``cpu``; each block runs the
kernels' plain versions.  The Sharder's routes alone are in
test_torch_parallel.py.  Tolerance: exact.
"""
import os
import random

import numpy as np
import pytest
import torch

from isocon_tpu.cli import main as jax_main
from isocon_tpu.io import read_fasta as jax_read_fasta
from isocon_tpu.ops.engine import PairEngine as JaxEngine
from isocon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from isocon_tpu.parallel.sharding import Sharder as JaxSharder
from isocon_tpu_torch import cli as port_cli
from isocon_tpu_torch.io import read_fasta
from isocon_tpu_torch.ops.engine import PairEngine
from isocon_tpu_torch.params import Params
from isocon_tpu_torch.parallel import Sharder, dryrun, make_mesh
from test_sharding import _noisy_copy, mutate, rand_seq
from test_torch_native import plain_port_routes


@pytest.fixture(scope="module", autouse=True)
def _plain_port_routes():
    """The port's engines in this file keep the plain K1/K2/K5 on the CPU
    (``ISOCON_NO_NATIVE=1``); ``tests/test_torch_native.py`` holds the
    host route."""
    with plain_port_routes():
        yield


def _cpu_mesh(n):
    return make_mesh(n, "cpu")


@pytest.fixture(scope="module")
def engine_case():
    """``test_sharding.py::test_sharded_engine_matches_local``'s pairs, the
    JAX engine's answers under ``Sharder(make_mesh(8))`` (its banded kernel
    route, the one the port follows) and the port's local engine's."""
    rng = random.Random(0)
    pairs = []
    for _ in range(24):
        a = rand_seq(rng, rng.randrange(60, 200))
        b = mutate(rng, a, rng.randrange(0, 20))
        pairs.append((a, b))
    caps = np.random.default_rng(1).integers(0, 30, len(pairs))
    scores = [(2, -2, 2, 0)] * len(pairs)

    def calls(engine):
        return {"nw": engine.edit_distances(pairs),
                "capped": engine.edit_distances(pairs, k_cap=caps),
                "hw": engine.edit_distances(pairs, hw_mode=True),
                "align": engine.align_pairs(pairs, scores)}

    jax_engine = JaxEngine(batch_pairs=16, sharder=JaxSharder(
        jax_make_mesh(8)))
    local = PairEngine(device="cpu")
    return calls, calls(jax_engine), calls(local), local


def _same_calls(got, want):
    for key in ("nw", "capped"):
        np.testing.assert_array_equal(got[key][0], want[key][0])
    ed, ej = got["hw"]
    np.testing.assert_array_equal(ed, want["hw"][0])
    known = want["hw"][0] >= 0
    np.testing.assert_array_equal(ej[known], want["hw"][1][known])
    assert got["align"] == want["align"]


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_engine_matches_local_and_jax(engine_case, n):
    calls, jax_want, local_want, local = engine_case
    engine = PairEngine(device="cpu", sharder=Sharder(_cpu_mesh(n)))
    assert engine.device == torch.device("cpu") and engine.sharder.n == n
    got = calls(engine)
    _same_calls(got, jax_want)
    _same_calls(got, local_want)
    np.testing.assert_array_equal(got["hw"][1], local_want["hw"][1])
    # the counters count the caller's pairs, never the padding
    for key, value in local.counters.items():
        if not key.endswith("seconds"):
            assert engine.counters[key] == value, key
    assert engine.myers_rungs == local.myers_rungs


class _RecordingSharder(Sharder):
    """A Sharder that records the order of its launches and collects."""

    def __init__(self, devices):
        super().__init__(devices)
        self.calls = []

    def launch(self, fn, tensors, vectors, **kw):
        self.calls.append(("launch", fn.__name__, len(vectors[0])))
        return super().launch(fn, tensors, vectors, **kw)

    def collect(self, batch):
        self.calls.append(("collect", batch.B))
        return super().collect(batch)


@pytest.mark.parametrize("n", [1, 2])
def test_engine_launches_a_round_before_collecting(n):
    """Every ED batch of a rung (here two pool widths, 256 and 512) is
    launched before the first is collected, with one block or several;
    an unsharded engine holds a Sharder of its own device."""
    rng = random.Random(3)
    pairs = []
    for k in (100, 300):
        for _ in range(4):
            a = rand_seq(rng, k)
            pairs.append((a, mutate(rng, a, 3)))
    if n == 1:
        engine = PairEngine(device="cpu")
        assert engine.sharder.devices == [torch.device("cpu")]
        engine.sharder = rec = _RecordingSharder(engine.sharder.devices)
    else:
        rec = _RecordingSharder(_cpu_mesh(n))
        engine = PairEngine(device="cpu", sharder=rec)
    ed, _ = engine.edit_distances(pairs)
    np.testing.assert_array_equal(ed, PairEngine(device="cpu")
                                  .edit_distances(pairs)[0])
    kinds = [c[0] for c in rec.calls]
    assert kinds[:4] == ["launch", "launch", "collect", "collect"]
    assert [c[1] for c in rec.calls[:2]] == ["myers_ed_pool"] * 2


def test_engine_replicas_follow_pool_growth():
    """An engine on ``cpu`` and ``cpu:0`` (a device the pools are not on,
    so its block reads a copy) equals a local engine while the pool takes
    new rows and grows past its first 1,024 rows: only appended rows are
    copied, the whole again after a growth."""
    rng = random.Random(6)
    local = PairEngine(device="cpu")
    mixed = PairEngine(device="cpu", sharder=Sharder(
        [torch.device("cpu"), torch.device("cpu", 0)]))
    scores = (2, -2, 2, 0)
    for n in (100, 200, 400):     # rows: appended, then grown
        pairs = [(a, mutate(rng, a, rng.randrange(0, 8))) for a in (
            rand_seq(rng, rng.randrange(80, 200)) for _ in range(n))]
        for got, want in zip(mixed.edit_distances(pairs),
                             local.edit_distances(pairs)):
            np.testing.assert_array_equal(got, want)
        assert (mixed.align_pairs(pairs[:20], [scores] * 20)
                == local.align_pairs(pairs[:20], [scores] * 20))
    assert local.sharder._replicas == {}
    kept = list(mixed.sharder._replicas.values())
    assert len(kept) == 3          # the live pool's mat, lens, Peq planes
    assert min(rows for _ref, _copy, rows in kept) > 1024


def test_dryrun_runs_on_the_card_by_default():
    """The seam's command and ``run`` take the card unless asked for the
    CPU; without a card the command raises before it starts a worker."""
    import inspect

    assert inspect.signature(dryrun.run).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        dryrun.main(["--procs", "2", "--local", "1"])


def _pipeline_reads(path):
    """``test_sharding.py::test_sharded_pipeline_matches_local``'s reads."""
    rng = random.Random(7)
    base = "".join(rng.choice("ACGT") for _ in range(260))
    bl = list(base)
    for pos in (30, 130, 230):
        bl[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bl[pos]]
    iso_a, iso_b = base, "".join(bl)
    with open(path, "w") as fh:
        for i in range(12):
            fh.write(">ra_%d\n%s\n" % (i, _noisy_copy(rng, iso_a, 0.01)))
        for i in range(12):
            fh.write(">rb_%d\n%s\n" % (i, _noisy_copy(rng, iso_b, 0.01)))
    return iso_a, iso_b


def _sorted_outputs(out, read_fasta):
    """As ``test_sharded_pipeline_matches_local`` compares."""
    cands = sorted((acc.split("_support_")[-1], seq)
                   for acc, seq in read_fasta(out + "/final_candidates.fa"))
    info = sorted(tuple(line.split())
                  for line in open(out + "/cluster_info.tsv") if line.strip())
    return cands, info


def test_sharded_pipeline_matches_local_and_jax(tmp_path):
    reads = str(tmp_path / "reads.fa")
    isoforms = _pipeline_reads(reads)
    runs = {}
    for ndev in (1, 4):
        out = str(tmp_path / ("port_%d" % ndev))
        engine, phase1 = port_cli.main(
            ["pipeline", "-fl_reads", reads, "-outfolder", out,
             "--batch_pairs", "32", "--device", "cpu", "--devices",
             str(ndev)])
        assert engine.sharder.n == ndev
        files = {}
        for name in ("final_candidates.fa", "candidates_converged.fa",
                     "cluster_info.tsv"):
            with open(os.path.join(out, name), "rb") as fh:
                files[name] = fh.read()
        runs[ndev] = (out, files, phase1, dict(engine.counters))
    assert runs[4][1] == runs[1][1]
    for key in ("ed_calls", "ed_pairs", "align_calls", "align_pairs"):
        assert runs[4][2][key] == runs[1][2][key], key
        assert runs[4][3][key] == runs[1][3][key], key
    jax_out = str(tmp_path / "jax_8")
    jax_main(["pipeline", "-fl_reads", reads, "-outfolder", jax_out,
              "--batch_pairs", "32", "--devices", "8"])
    got = _sorted_outputs(runs[4][0], read_fasta)
    assert got == _sorted_outputs(jax_out, jax_read_fasta)
    assert {s for _sup, s in got[0]} == set(isoforms)


# ---------------------------------------------------------------------------
# the multi-process seam and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("local", [2, (1, 3)], ids=["2x2", "1+3"])
def test_seam_two_processes_match_local(tmp_path, local):
    """Two processes on a free localhost port over gloo, each with its
    logical CPU shards: both read every result, equal to a local
    engine's.  ``dryrun.run`` joins with a timeout and kills the workers
    when it expires (no pytest-timeout here)."""
    pairs = dryrun.seeded_pairs(16)
    scores = [(2, -2, 2, 0)] * len(pairs)
    want = dryrun.engine_results(PairEngine(device="cpu"), pairs, pairs,
                                 scores)
    got = dryrun.run(pairs, pairs, scores, procs=2, local=local,
                     device="cpu", timeout=90, workdir=str(tmp_path))
    shards = [local] * 2 if isinstance(local, int) else list(local)
    assert [r["rank"] for r in got] == [0, 1]
    for r in got:
        assert r["ranks"] == [0] * shards[0] + [1] * shards[1]
        for key in ("ed", "alignments", "volume"):
            assert r[key] == want[key], (r["rank"], key)


def test_make_engine_builds_the_sharder(tmp_path):
    reads = str(tmp_path / "r.fa")
    with open(reads, "w") as fh:
        fh.write(">r\nACGT\n")
    base = ["pipeline", "-fl_reads", reads, "-outfolder",
            str(tmp_path / "o"), "--device", "cpu"]
    _run, params = port_cli.parse(base + ["--devices", "2"])
    engine = port_cli.make_engine(params)
    assert engine.sharder.devices == [torch.device("cpu")] * 2
    assert params.device_mesh == engine.sharder.devices
    _run, params = port_cli.parse(base + ["--devices", "-1"])
    assert port_cli.make_engine(params).sharder.n == 1
    _run, params = port_cli.parse(base)
    engine = port_cli.make_engine(params)
    assert params.device_mesh is None
    assert engine.sharder.devices == [torch.device("cpu")]
    engine = port_cli.make_engine(Params(device="cpu", device_mesh=[
        torch.device("cpu")] * 3))
    assert engine.sharder.n == 3
    # as the JAX package's make_engine: only N > 1 or -1 builds a mesh
    _run, params = port_cli.parse(base + ["--devices", "0"])
    assert port_cli.make_engine(params).sharder.n == 1
    assert params.device_mesh is None
