"""The ``--nontargeted`` slice: the port's sketch retrieval
(``isocon_tpu_torch/graph/sketch.py``, ``ops/sketch.py``; plain versions on
the CPU) against the JAX package's ``isocon_tpu/graph/sketch.py``.

The JAX function's score is a dot that XLA:CPU sums in an order of its
own choosing, which depends on the matrix's shape
(``tools/xla_dot_order.py``).  At 3,000 rows (and at 2, 3, 50 and 64) it
is one in-order chain of float32 fmas per entry, the order the port
fixes; there the port's scores and top-n lists must equal
``_topn_scores``'s bit for bit.  The slice's outputs must be byte-identical
at every size tried.  Tolerance: exact everywhere.
"""
import hashlib
import importlib.util
import os
import random
import sys
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isocon_tpu import cli as jax_cli
from isocon_tpu.graph import sketch as jax_sketch
from isocon_tpu.ops.engine import PairEngine as JaxEngine
from isocon_tpu_torch import cli as port_cli
from isocon_tpu_torch.graph import sketch as port_sketch
from isocon_tpu_torch.io import read_fasta
from isocon_tpu_torch.ops import sketch as ops_sketch
from isocon_tpu_torch.ops.engine import PairEngine
from isocon_tpu_torch.workload import make_family, noisy_copy, write_reads
from test_sketch import mutate, rand_seq
from test_torch_native import plain_port_routes


@pytest.fixture(scope="module", autouse=True)
def _plain_port_routes():
    """The port's engines in this file keep the plain K1/K2/K5 on the CPU
    (``ISOCON_NO_NATIVE=1``); ``tests/test_torch_native.py`` holds the
    host route."""
    with plain_port_routes():
        yield

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name, argv=None):
    """Import a script of the repo by path (``argv``: its sys.argv while it
    is imported)."""
    saved = sys.argv
    sys.argv = argv if argv is not None else saved
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _port_rows(profiles, lens, row0, rows, k):
    """The port's plain scores of rows row0 .. row0 + rows - 1 and their
    top-k: (values, indices) as numpy."""
    p = torch.sqrt(torch.from_numpy(profiles))
    scores = ops_sketch.sketch_scores_plain(p, torch.from_numpy(lens), row0,
                                            rows)
    vals, idx = ops_sketch.topn(scores, k)
    return vals.numpy(), idx.numpy()


def _profiles(seqs):
    return (np.stack([jax_sketch.kmer_profile(s) for s in seqs]),
            np.array([len(s) for s in seqs], dtype=np.int32))


# ---------------------------------------------------------------------------
# k-mer profiles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [
    "", "A", "ACGTACG", "ACGTACGT", "acgtNNacgtRYacgt",
    "".join(random.Random(3).choice("ACGTN") for _ in range(1500))],
    ids=["empty", "one", "seven", "eight", "iupac", "long"])
def test_kmer_profile_matches_jax(seq):
    got = port_sketch.kmer_profile(seq)
    want = jax_sketch.kmer_profile(seq)
    assert got.dtype == np.float32 and got.shape == (port_sketch.DIM,)
    assert np.array_equal(got, want)
    assert (port_sketch.KMER, port_sketch.DIM, port_sketch.TOPN) == (
        jax_sketch.KMER, jax_sketch.DIM, jax_sketch.TOPN)


# ---------------------------------------------------------------------------
# scores and top-n at 3,000 rows, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reads3000(tmp_path_factory):
    """3,000 unique reads of the four-family workload, their profiles and
    lengths, and the JAX function's top-20 on them."""
    path = str(tmp_path_factory.mktemp("sketch") / "reads.fa")
    write_reads(path, 3000, families=4)
    seqs = sorted({s for _a, s in read_fasta(path)})
    assert len(seqs) == 3000
    prof, lens = _profiles(seqs)
    vals, idx = jax_sketch._topn_scores(jnp.asarray(prof), jnp.asarray(lens),
                                        20)
    return prof, lens, np.asarray(vals), np.asarray(idx)


ROW_SLICES = [(0, 96), (1480, 64), (2904, 96)]


@pytest.mark.parametrize("row0,rows", ROW_SLICES)
def test_scores_and_topn_match_jax_bit_for_bit(reads3000, row0, rows):
    prof, lens, vals, idx = reads3000
    got_v, got_i = _port_rows(prof, lens, row0, rows, 20)
    assert np.array_equal(_bits(got_v), _bits(vals[row0:row0 + rows]))
    assert np.array_equal(got_i, idx[row0:row0 + rows])


@pytest.mark.parametrize("row0,rows", ROW_SLICES)
def test_duplicated_profiles_tie_as_top_k(reads3000, row0, rows):
    """1,500 profiles, each twice (rows r and r + 1,500): every neighbour
    scores twice, exactly; the lower index comes first, as in lax.top_k."""
    prof, lens, _v, _i = reads3000
    prof = np.concatenate([prof[:1500], prof[:1500]])
    lens = np.concatenate([lens[:1500], lens[:1500]])
    vals, idx = jax_sketch._topn_scores(jnp.asarray(prof), jnp.asarray(lens),
                                        20)
    vals, idx = np.asarray(vals), np.asarray(idx)
    got_v, got_i = _port_rows(prof, lens, row0, rows, 20)
    assert np.array_equal(_bits(got_v), _bits(vals[row0:row0 + rows]))
    assert np.array_equal(got_i, idx[row0:row0 + rows])
    # the lists do hold ties, each pair in index order
    tied = got_v[:, 1:] == got_v[:, :-1]
    assert tied.sum() >= rows * 5
    assert (got_i[:, 1:][tied] > got_i[:, :-1][tied]).all()


@pytest.mark.parametrize("n", [2, 3, 50, 64])
def test_small_n_matches_jax_bit_for_bit(n):
    """topn above n - 1 takes k = n - 1, as approximate_matches does."""
    rs = np.random.default_rng(n)
    prof = rs.poisson(3, size=(n, 512)).astype(np.float32)
    prof[-1] = prof[0]              # a tie in every row
    lens = rs.integers(300, 320, n).astype(np.int32)
    k = min(20, n - 1)
    vals, idx = jax_sketch._topn_scores(jnp.asarray(prof), jnp.asarray(lens),
                                        k)
    got_v, got_i = _port_rows(prof, lens, 0, n, k)
    assert np.array_equal(_bits(got_v), _bits(vals))
    assert np.array_equal(got_i, np.asarray(idx))


@pytest.mark.parametrize("n", [0, 1, 2, 5, 30])
def test_approximate_matches_match_jax(n):
    rng = random.Random(n)
    center = rand_seq(rng, 200)
    seqs = [mutate(rng, center, rng.randrange(1, 6)) for _ in range(n)]
    want = jax_sketch.approximate_matches(seqs)
    got = port_sketch.approximate_matches(seqs, device="cpu")
    assert got == want
    assert all(len(c) == min(20, n - 1) for c in got)


def test_sketch_defaults_to_cuda():
    """Without a card and without device="cpu" the sketch raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sketch.approximate_matches(["ACGTACGTAC", "ACGTACGTAA"])


def test_topn_indices_chunks_equal_one_chunk():
    rs = np.random.default_rng(5)
    prof = rs.poisson(2, size=(150, 64)).astype(np.float32)
    prof[100:] = prof[:50]
    p = torch.sqrt(torch.from_numpy(prof))
    lens = torch.from_numpy(rs.integers(90, 110, 150).astype(np.int32))
    whole = ops_sketch.topn_indices(p, lens, 20, chunk=150)
    for chunk in (1, 7, 64, 149):
        assert torch.equal(ops_sketch.topn_indices(p, lens, 20, chunk=chunk),
                           whole)


# ---------------------------------------------------------------------------
# the plain version's fmaf
# ---------------------------------------------------------------------------
def _round_f32(fr):
    """The float32 nearest the rational ``fr``, ties to even."""
    x = np.float32(float(fr))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - fr),
                                     int(_bits(c)) & 1))


def _exact_fmaf(a, b, c):
    return np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)


def _fmaf(a, b, c):
    a, b, c = (torch.from_numpy(np.asarray(x, np.float32)).double()
               for x in (a, b, c))
    return ops_sketch.fmaf_plain(c, a * b).float().numpy()


def test_fmaf_plain_matches_exact_rationals_random():
    rs = np.random.default_rng(11)
    n = 6000
    scale = lambda: 2.0 ** rs.integers(-30, 31, n)
    a = (rs.standard_normal(n) * scale()).astype(np.float32)
    b = (rs.standard_normal(n) * scale()).astype(np.float32)
    c = (rs.standard_normal(n) * scale()).astype(np.float32)
    c[:500] = -(a[:500].astype(np.float64) * b[:500]).astype(np.float32)
    assert np.array_equal(_bits(_fmaf(a, b, c)), _bits(_exact_fmaf(a, b, c)))


def test_fmaf_plain_matches_exact_rationals_double_rounding():
    """Sums whose float64 value is a float32 midpoint while the exact sum
    is not: float64 then float32 rounds them the wrong way."""
    one_up = np.float32(1 + 2.0 ** -23)
    one_dn = np.float32(1 - 2.0 ** -23)
    a, b, c = [], [], []
    for k in range(-60, 61, 3):
        s = np.float32(2.0 ** k)
        for sign in (1, -1):
            # 2^24 + 2 + (1 - 2^-46): the float64 sum is 2^24 + 3
            a.append(sign * one_up * s)
            b.append(one_dn)
            c.append(sign * np.float32(2.0 ** 24 + 2) * s)
            # 2^24 + 6 - (1 - 2^-46): the float64 sum is 2^24 + 5
            a.append(-sign * one_up * s)
            b.append(one_dn)
            c.append(sign * np.float32(2.0 ** 24 + 6) * s)
    a, b, c = (np.array(x, dtype=np.float32) for x in (a, b, c))
    want = _exact_fmaf(a, b, c)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).all()
    assert np.array_equal(_bits(_fmaf(a, b, c)), _bits(want))


def test_smoke_expect_pin_equals_the_plain_version():
    """The expectation's pinned JAX function (tools/smoke_expect.py) gives
    the plain version's values and lists."""
    tool = _load(os.path.join(ROOT, "tools", "smoke_expect.py"),
                 "smoke_expect_tool")
    rs = np.random.default_rng(2)
    prof = rs.poisson(3, size=(300, 512)).astype(np.float32)
    prof[200:] = prof[:100]
    lens = rs.integers(700, 1800, 300).astype(np.int32)
    vals, idx = tool.topn_scores_sequential_fma(prof, lens, 20)
    got_v, got_i = _port_rows(prof, lens, 0, 300, 20)
    assert np.array_equal(_bits(vals), _bits(got_v))
    assert np.array_equal(idx, got_i)


# ---------------------------------------------------------------------------
# the approximate NN graph
# ---------------------------------------------------------------------------
def _graph_cases():
    """tests/test_sketch.py's two inputs (with their topn), and the second
    with every third sequence converged."""
    rng = random.Random(0)
    seqs = []
    for _c in range(4):
        center = rand_seq(rng, 300)
        for _ in range(4):
            seqs.append(mutate(rng, center, rng.randrange(1, 5)))
    rng = random.Random(1)
    center_a = rand_seq(rng, 200)
    center_b = rand_seq(rng, 210)
    pair = sorted(
        {mutate(rng, center_a, rng.randrange(1, 4)) for _ in range(5)}
        | {mutate(rng, center_b, rng.randrange(1, 4)) for _ in range(5)})
    return {
        "clusters": (seqs, [False] * len(seqs), 5),
        "two_centers": (pair, [False] * len(pair), 6),
        "converged": (pair, [i % 3 == 0 for i in range(len(pair))], 6),
        "default_topn": (seqs, [False] * len(seqs), 20),
    }


@pytest.mark.parametrize("case", list(_graph_cases()))
def test_approximate_nn_graph_matches_jax(case):
    seqs, conv, topn = _graph_cases()[case]
    want = jax_sketch.approximate_nn_graph(seqs, conv,
                                           JaxEngine(batch_pairs=16), topn)
    engine = PairEngine(device="cpu")
    got = port_sketch.approximate_nn_graph(seqs, conv, engine, topn)
    assert [list(d.items()) for d in got] == [list(d.items()) for d in want]
    assert any(got)
    assert engine.counters["sketch_rows"] == len(seqs)
    assert engine.counters["ed_pairs"] == sum(
        min(topn, len(seqs) - 1) for c in conv if not c)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nontargeted_inputs(tmp_path_factory):
    """Two read sets: two gene families of 26 short isoforms (162-330
    bases) x about 6 noisy reads (300 reads), and test_pipeline_e2e.py's
    28 reads of two 300-base isoforms."""
    d = str(tmp_path_factory.mktemp("nontargeted"))
    rng = random.Random(11)
    isoforms = make_family(rng, (70, 40, 60, 50, 80, 30))
    isoforms += make_family(rng, tuple(rng.randrange(25, 90)
                                       for _ in range(6)))
    two = os.path.join(d, "two_families.fa")
    with open(two, "w") as fh:
        for i in range(300):
            fh.write(">read_%d\n%s\n" % (
                i, noisy_copy(rng, isoforms[i % len(isoforms)])))
    rng = random.Random(42)
    base = rand_seq(rng, 300)
    bl = list(base)
    for pos in (40, 150, 260):
        bl[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bl[pos]]
    reads = {}
    for i in range(14):
        reads["read_a_%d" % i] = noisy_copy(rng, base, 0.01)
    for i in range(14):
        reads["read_b_%d" % i] = noisy_copy(rng, "".join(bl), 0.01)
    e2e = os.path.join(d, "e2e.fa")
    with open(e2e, "w") as fh:
        for acc, seq in sorted(reads.items()):
            fh.write(">%s\n%s\n" % (acc, seq))
    return {"dir": d, "two_families": two, "e2e": e2e}


@pytest.mark.parametrize("which", ["get_candidates", "pipeline"])
@pytest.mark.parametrize("data", ["two_families", "e2e"])
def test_nontargeted_cli_byte_identical(nontargeted_inputs, data, which):
    reads = nontargeted_inputs[data]
    base = os.path.join(nontargeted_inputs["dir"], "%s_%s" % (data, which))
    engines = []
    make_engine = jax_cli.make_engine

    def recording(params):
        engines.append(make_engine(params))
        return engines[-1]

    jax_cli.make_engine = recording
    try:
        jax_cli.main([which, "-fl_reads", reads, "-outfolder", base + "_jax",
                      "--nontargeted"])
    finally:
        jax_cli.make_engine = make_engine
    got = port_cli.main([which, "-fl_reads", reads, "-outfolder",
                         base + "_torch", "--nontargeted", "--device", "cpu"])
    engine = got[0] if isinstance(got, tuple) else got
    names = ["candidates_converged.fa"]
    if which == "pipeline":
        names += ["final_candidates.fa", "cluster_info.tsv"]
    for name in names:
        with open(os.path.join(base + "_jax", name), "rb") as fh:
            want = fh.read()
        with open(os.path.join(base + "_torch", name), "rb") as fh:
            assert fh.read() == want, name
        assert want.count(b">") >= 2 or name == "cluster_info.tsv"
    (jax_engine,) = engines
    for key in ("ed_calls", "ed_pairs", "align_calls", "align_pairs"):
        assert engine.counters[key] == jax_engine.counters[key], key
    assert engine.counters["sketch_rows"] > 0
    # every pair the Myers kernels ran is counted at its window
    assert engine.myers_rungs[("NW", 7)] > 0
    assert engine.counters["ed_pairs_full_window"] == sum(
        k for (_mode, win), k in engine.myers_rungs.items() if win == 0)


# ---------------------------------------------------------------------------
# the workload
# ---------------------------------------------------------------------------
def test_write_reads_one_family_is_unchanged(tmp_path):
    path = str(tmp_path / "reads.fa")
    write_reads(path, 120)
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    assert digest == ("b6ef3a55ff0c91d290c8d991583d5d6cc884d61d8ec56e2717ab8c5"
                      "e8cc8d0e5")


@pytest.mark.parametrize("families", [1, 4])
def test_write_reads_families_equal_bench_10k(tmp_path, families):
    bench = _load(os.path.join(ROOT, "scripts", "bench_10k.py"),
                  "bench_10k_script", argv=["bench_10k.py"])
    n = 300
    rng = random.Random(123)
    isoforms = bench.make_isoforms(rng, families)
    want = "".join(">read_%d\n%s\n" % (i, bench.noisy_copy(
        rng, isoforms[i % len(isoforms)])) for i in range(n))
    path = str(tmp_path / "reads.fa")
    got_isoforms = write_reads(path, n, families=families)
    assert got_isoforms == isoforms
    assert len(isoforms) == 26 * families
    with open(path) as fh:
        assert fh.read() == want
