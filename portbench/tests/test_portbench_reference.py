"""The benchmark's plain reference against the port's own numpy oracle
(``isocon_tpu_torch/ops/oracle.py``) on small pairs.  The test imports
both; the reference imports neither."""
import random

import numpy as np
import pytest

from isocon_tpu_torch.ops import oracle
from portbench import reference


def _mutate(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate * 0.4:
            out.append(rng.choice("ACGT"))
        elif r < rate * 0.7:
            out.append(ch + rng.choice("ACGT"))
        elif r < rate:
            pass
        else:
            out.append(ch)
    return "".join(out)


def _pairs(seed, n=48):
    rng = random.Random(seed)
    pairs = []
    for k in range(n):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randrange(0, 120)))
        if k % 4 == 0:
            b = "".join(rng.choice("ACGT") for _ in range(rng.randrange(0, 120)))
        else:
            b = _mutate(rng, a, 0.15)
        if k % 5 == 0:
            b = "GATTACA"[: k % 7] + b + "TTG"
        pairs.append((a, b))
    pairs += [("", ""), ("", "ACG"), ("ACG", ""), ("A", "A"), ("A", "C")]
    return pairs


@pytest.mark.parametrize("seed", [1, 2])
def test_nw_distances(seed):
    pairs = _pairs(seed)
    got, _rows = reference.edit_distances(pairs, False, "cpu")
    want = [oracle.edit_distance(a, b) for a, b in pairs]
    assert got.tolist() == want


@pytest.mark.parametrize("seed", [3, 4])
def test_hw_distances_and_end_columns(seed):
    pairs = _pairs(seed)
    got, rows = reference.edit_distances(pairs, True, "cpu")
    for (a, b), d, row in zip(pairs, got, rows):
        ed, _start, end, _ops = oracle.edit_distance_hw(a, b)
        assert d == ed
        assert len(row) == len(b) + 1
        # the oracle's end is inclusive; the row is indexed by exclusive end
        assert row[end + 1] == ed and row.min() == ed


@pytest.mark.parametrize("scores", [(2, -3, 3, 1), (2, -2, 2, 0),
                                    (2, -1, 2, 0), (2, -4, 2, 0)])
def test_semi_global_scores_and_alignment_scores(scores):
    pairs = _pairs(5)
    best = reference.semi_global_scores(pairs, [scores] * len(pairs), "cpu")
    for (a, b), s in zip(pairs, best):
        a1, a2, counts = oracle.align_semi_global(a, b, *scores)
        got = reference.alignment_score(a1, a2, a, b, scores)
        assert got == (s, tuple(counts))


def test_alignment_score_rejects_what_is_no_alignment():
    sc = (2, -3, 3, 1)
    assert reference.alignment_score("AC-T", "ACGT", "ACT", "ACGT", sc) == \
        (6 - 3, (3, 0, 1))
    assert reference.alignment_score("AC-T", "ACGT", "ACTT", "ACGT", sc) is None
    assert reference.alignment_score("AC-", "ACG-", "AC", "ACG", sc) is None
    assert reference.alignment_score("A-C", "A-G", "AC", "AG", sc) is None
    # end gaps are free on both ends, in both sequences
    assert reference.alignment_score("--AC", "GGAC", "AC", "GGAC", sc)[0] == 4
    assert reference.alignment_score("ACGG", "AC--", "ACGG", "AC", sc)[0] == 4
    # a worse alignment of the same pair scores lower than the optimum
    a, b = "ACGTACGT", "ACGTTACGT"
    best = reference.semi_global_scores([(a, b)], [sc], "cpu")[0]
    assert reference.alignment_score("ACGT-ACGT", "ACGTTACGT", a, b, sc)[0] \
        == best
    assert reference.alignment_score("ACGTA-CGT", "ACGTTACGT", a, b, sc)[0] \
        < best


def test_blocks_cover_every_pair_once():
    la = np.array([5, 300, 20, 300, 7])
    lb = np.array([9, 280, 25, 310, 3])
    old = reference.BLOCK_ELEMENTS
    reference.BLOCK_ELEMENTS = 700
    try:
        seen = np.concatenate(list(reference._blocks(la, lb)))
        pairs = [("A" * x, "C" * y) for x, y in zip(la, lb)]
        got, _ = reference.edit_distances(pairs, False, "cpu")
    finally:
        reference.BLOCK_ELEMENTS = old
    assert sorted(seen.tolist()) == [0, 1, 2, 3, 4]
    assert got.tolist() == np.maximum(la, lb).tolist()
