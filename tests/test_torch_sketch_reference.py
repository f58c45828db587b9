"""The port's sketch retrieval (``graph/sketch.py``; K6's plain version on
the CPU) against its plain float64 reference
(``isocon_tpu_torch/graph/sketch_reference.py``), on seeded reads of two
gene families of short isoforms.

Profiles and edge sets must be equal exactly.  The scores may not be: the
port sums each one as a float32 ``fmaf`` chain from float32 square roots,
the reference in float64.  So a port score must lie within beta of the
float64 one (``sketch_reference.score_bound``: 512 chain roundings, two of
the square roots and one of the subtraction, u = 2^-24 each, times
sum |sqrt(p_i) sqrt(p_j)| + |len_i - len_j|), and a port list must be a top
N under scores that far off (``check_rows``).  Lists computed from profiles
rounded to TF32's 10-bit mantissa must fail that score check: the
tolerance is tight enough to see the next precision down.
"""
import random

import numpy as np
import pytest
import torch

from isocon_tpu_torch.graph import sketch as port
from isocon_tpu_torch.graph import sketch_reference as ref
from isocon_tpu_torch.ops import sketch as ops_sketch
from isocon_tpu_torch.ops.engine import PairEngine
from isocon_tpu_torch.workload import make_family, noisy_copy


def _reads(seed: int, n: int):
    """Sorted unique noisy reads (1% noise) of two families of 26 isoforms
    of about 160-330 bases, drawn round-robin."""
    rng = random.Random(seed)
    iso = make_family(rng, (70, 40, 60, 50, 80, 30))
    iso += make_family(rng, tuple(rng.randrange(25, 90) for _ in range(6)))
    return sorted({noisy_copy(rng, iso[i % len(iso)]) for i in range(n)})


@pytest.fixture(scope="module")
def reads():
    return _reads(7, 160)


def _port_lists(seqs, roots=None):
    """The port's top-20 values and indices on the CPU, from its own
    square-rooted profiles or from ``roots``."""
    if roots is None:
        roots = torch.from_numpy(
            np.sqrt(np.stack([port.kmer_profile(s) for s in seqs])))
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    vals, idx = ops_sketch.topn_scores(roots, lens, min(20, len(seqs) - 1))
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("case", ["reads", "letters", "short"])
def test_profiles_equal_the_port(reads, case):
    if case == "reads":
        seqs = reads
    elif case == "letters":
        rng = random.Random(3)
        seqs = ["".join(rng.choice("ACGTNacgtnRY") for _ in range(n))
                for n in (9, 40, 300)]
    else:
        seqs = ["", "ACGTACG", "ACGTACGT", "ACGTACGTA"]
    want = np.stack([port.kmer_profile(s) for s in seqs]).astype(np.float64)
    got = ref.profiles(seqs).numpy()
    assert np.array_equal(got, want)
    assert got.sum() == sum(max(len(s) - 7, 0) for s in seqs)


def test_port_lists_are_valid_top_n(reads):
    vals, idx = _port_lists(reads)
    # the graph's own entry gives the same lists
    assert port.approximate_matches(reads, device="cpu") == idx.tolist()
    lens = [len(s) for s in reads]
    got = ref.check_rows(ref.profiles(reads), lens, list(range(len(reads))),
                         idx, vals)
    assert got["rows"] == len(reads)
    assert got["lists_invalid"] == 0
    assert got["scores_outside"] == 0
    assert got["worst_score_ratio"] < 1.0


def test_check_rows_catches_a_wrong_list(reads):
    """Each row's list rotated to the next row's is no top N of its own."""
    vals, idx = _port_lists(reads)
    lens = [len(s) for s in reads]
    got = ref.check_rows(ref.profiles(reads), lens, list(range(len(reads))),
                         np.roll(idx, 1, axis=0), np.roll(vals, 1, axis=0))
    assert got["lists_invalid"] > len(reads) // 2
    assert got["scores_outside"] > 0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties even)."""
    bits = x.view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def test_tf32_profiles_fail_the_score_check(reads):
    roots = torch.from_numpy(
        np.sqrt(np.stack([port.kmer_profile(s) for s in reads])))
    vals, idx = _port_lists(reads, _tf32(roots.clone()))
    lens = [len(s) for s in reads]
    got = ref.check_rows(ref.profiles(reads), lens, list(range(len(reads))),
                         idx, vals)
    assert got["scores_outside"] > idx.size // 10
    assert got["worst_score_ratio"] > 1.5


@pytest.mark.parametrize("case", ["unconverged", "converged", "topn5"])
def test_nn_graph_equals_the_reference(reads, case):
    seqs = reads if case != "topn5" else reads[:60]
    conv = ([i % 3 == 0 for i in range(len(seqs))] if case == "converged"
            else [False] * len(seqs))
    topn = 5 if case == "topn5" else 20
    engine = PairEngine(device="cpu")
    got = port.approximate_nn_graph(seqs, conv, engine, topn)
    want = ref.nn_graph(seqs, conv, topn)
    assert got == want
    assert sum(map(len, got)) > len(seqs) // 2
    n = len(seqs)
    assert engine.counters["sketch_pairs"] == sum(
        min(topn, n - 1) for c in conv if not c)
    assert engine.counters["sketch_score_cells"] == n * (n - 1) // 2
    assert engine.counters["sketch_rows"] == n
    assert 0 < engine.counters["sketch_profile_seconds"] \
        <= engine.counters["sketch_seconds"]


def test_reference_dp_is_the_textbook_distance():
    rng = random.Random(5)
    pairs = [("", ""), ("", "ACG"), ("ACGT", ""), ("ACGT", "ACGT"),
             ("ACGT", "AGT"), ("kitten", "sitting")]
    pairs += [("".join(rng.choice("ACGT") for _ in range(rng.randrange(30))),
               "".join(rng.choice("ACGT") for _ in range(rng.randrange(30))))
              for _ in range(40)]

    def textbook(a, b):
        row = list(range(len(b) + 1))
        for i, x in enumerate(a, 1):
            new = [i]
            for j, y in enumerate(b, 1):
                new.append(min(row[j - 1] + (x != y), row[j] + 1,
                               new[j - 1] + 1))
            row = new
        return row[-1]

    got = ref.nw_distances(pairs)
    assert got.tolist() == [textbook(a, b) for a, b in pairs]
