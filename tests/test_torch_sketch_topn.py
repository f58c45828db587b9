"""The fused top-n of K6 (``isocon_tpu_torch/ops/sketch.py``) on the CPU.

The card computes ``_topn_scores`` in two passes: each row's k best of
each column segment (``sketch_topn``), then each row's merge of its lists
(``merge_topn``).  Here their plain versions (``segment_topn_plain`` /
``sketch_topn_plain`` and ``merge_topn_plain``) are held to ``topn`` and
to the JAX package's ``lax.top_k`` / ``_topn_scores``; the segment plan is
checked to cover every column once; and the kernel's selection rule
(``csrc/sketch.cu::select_row``: a 32-slot list a row, one lane a slot,
a tile's 128 columns against the k-th pair, up to 32 passing merged by
rank, more sorted as four groups of 32 by bitonic networks and merged) and its merge (a
warp's butterfly over the lists' heads) are emulated lane for lane in
numpy and held to the plain versions.  Tolerance: exact (bit for bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isocon_tpu.graph import sketch as jax_sketch
from isocon_tpu_torch.ops import sketch as sk

LANES = np.arange(32)
PAD = (np.float32(-np.inf), sk.PAD_INDEX)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _both(scores, k, bounds):
    """merge_topn_plain of segment_topn_plain: (values, indices) numpy."""
    v, i = sk.merge_topn_plain(*sk.segment_topn_plain(scores, k, bounds), k)
    return v.numpy(), i.numpy()


def _given_scores(kind, n, seed):
    """float32 [n, n] score matrices that stress the order."""
    rs = np.random.default_rng(seed)
    if kind == "integer_ties":
        s = rs.integers(-4, 5, size=(n, n)).astype(np.float32)
    elif kind == "diagonal":
        s = rs.integers(0, 3, size=(n, n)).astype(np.float32) * 0.5
        s[np.arange(n), np.arange(n)] -= np.float32(1e9)
    elif kind == "equal_rows":
        s = rs.integers(0, 3, size=(n, n)).astype(np.float32)
        s[::3] = 7.0
    else:                        # signed zeros among small integers
        s = rs.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32),
                      size=(n, n))
    return s


def _bound_sets(n):
    """Column segments: one, the kernel's tiles, and narrow ones (some
    narrower than k, one column wide)."""
    sets = [[(0, n)], sk.segment_bounds(n, -(-n // sk.TILE))]
    cuts = sorted({0, n, 1, 2, 5, n // 3, n // 2, n - 1} & set(range(n + 1)))
    sets.append([(a, b) for a, b in zip(cuts, cuts[1:]) if b > a])
    return sets


@pytest.mark.parametrize("kind", ["integer_ties", "diagonal", "equal_rows",
                                  "signed_zero"])
@pytest.mark.parametrize("n,k", [(2, 1), (21, 20), (150, 20), (40, 1)])
def test_plain_passes_equal_topn_and_top_k(kind, n, k):
    s = _given_scores(kind, n, seed=n * 7 + k)
    want_v, want_i = (x.numpy() for x in sk.topn(torch.from_numpy(s), k))
    jv, ji = (np.asarray(x) for x in jax.lax.top_k(jnp.asarray(s), k))
    for bounds in _bound_sets(n):
        got_v, got_i = _both(torch.from_numpy(s), k, bounds)
        assert np.array_equal(_bits(got_v), _bits(want_v)), bounds
        assert np.array_equal(got_i, want_i), bounds
    # lax.top_k takes +0.0 above -0.0 (a total order); topn, the plain
    # passes and the kernel hold them equal, and a sketch score is never
    # -0.0 (test_scores_are_never_negative_zero), so on the scores the
    # function sees the two orders agree
    assert np.array_equal(got_v, jv)
    if kind != "signed_zero":
        assert np.array_equal(_bits(got_v), _bits(jv))
        assert np.array_equal(got_i, ji)


def _square_profiles(n, seed):
    """Seeded profiles whose square roots are the integers 0-3 (counts 0,
    1, 4, 9), every fourth row a copy of an earlier one, lengths of 300-305:
    every sum of products is an exact integer, so the JAX dot equals the
    sequential chain in whatever order XLA:CPU sums (at N = 21 and 150 it
    does not sum in sequence; tools/xla_dot_order.py)."""
    rs = np.random.default_rng(seed)
    prof = (rs.integers(0, 4, size=(n, 512)) ** 2).astype(np.float32)
    for r in range(4, n, 4):
        prof[r] = prof[r // 3]
    lens = rs.integers(300, 306, n).astype(np.int32)
    return prof, lens


@pytest.mark.parametrize("n", [2, 3, 21, 64, 150])
def test_plain_passes_match_jax_topn_scores(n):
    prof, lens = _square_profiles(n, seed=n)
    k = min(20, n - 1)
    jv, ji = (np.asarray(x) for x in jax_sketch._topn_scores(
        jnp.asarray(prof), jnp.asarray(lens), k))
    p = torch.sqrt(torch.from_numpy(prof))
    ln = torch.from_numpy(lens)
    for nseg in range(1, -(-n // sk.TILE) + 1):
        v, i = sk.merge_topn(*sk.sketch_topn(p, ln, k, nseg), k)
        assert np.array_equal(_bits(v.numpy()), _bits(jv)), nseg
        assert np.array_equal(i.numpy(), ji), nseg
    v, i = sk.topn_scores(p, ln, k, chunk=7)
    assert np.array_equal(_bits(v.numpy()), _bits(jv))
    assert np.array_equal(i.numpy(), ji)
    assert (jv[:, 1:] == jv[:, :-1]).any() or n <= 3   # ties are exercised


def test_scores_are_never_negative_zero():
    """acc >= +0.0 and x - x = +0.0, so a zero score is +0.0: zero rows of
    equal lengths, and rows whose sum equals the length difference."""
    prof = np.zeros((4, 32), np.float32)
    prof[2, 0] = prof[3, 0] = 2.0          # acc(2, 3) = 4 = |len2 - len3|
    lens = np.array([10, 10, 6, 10], np.int32)
    s = sk.sketch_scores_plain(torch.from_numpy(prof),
                               torch.from_numpy(lens), 0, 4)
    zeros = s[s == 0]
    assert zeros.numel() >= 3
    assert not torch.signbit(zeros).any()


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_segment_plan_covers_every_column_once(sms):
    for N in range(1, 301):
        nseg = sk.plan_segments(N, sms)
        tiles = -(-N // sk.TILE)
        assert 1 <= nseg <= min(tiles, sk.MAX_SEGMENTS)
        bounds = sk.segment_bounds(N, nseg)
        cols = [c for a, b in bounds for c in range(a, b)]
        assert cols == list(range(N))
        # every segment holds at least one column tile, whole but the last
        assert all(b > a and a % sk.TILE == 0 for a, b in bounds)
        assert all(b - a >= sk.TILE for a, b in bounds[:-1])


def test_segment_plan_fills_the_card():
    """At the nontargeted run's sizes and above, the plan's estimated time
    (``segment_cost``) is within 1.3 x its floor: every tile spread evenly
    over the SMs (at least one a SM) plus a segment's start; and it is the
    least over every count the kernel takes."""
    for N in (1102, 2000, 2999, 7446, 9922, 10000, 10001, 50000):
        tiles = -(-N // sk.TILE)
        nseg = sk.plan_segments(N, 132)
        cost = sk.segment_cost(tiles, nseg, 132)
        floor = max(tiles * tiles / 132, 1) + sk.SEGMENT_START_TILES
        assert cost <= 1.3 * floor, (N, nseg, cost, floor)
        assert cost == min(sk.segment_cost(tiles, s, 132)
                           for s in range(1, min(tiles, 32) + 1))


# ---------------------------------------------------------------------------
# the kernel's selection and merge, lane for lane
# ---------------------------------------------------------------------------
def _beats(v, i, w, j):
    return (v > w) | ((v == w) & (i < j))


def _exchange(v, i, stride, take_better):
    pv, pi = v[LANES ^ stride], i[LANES ^ stride]
    t = _beats(pv, pi, v, i) == take_better
    return np.where(t, pv, v), np.where(t, pi, i)


def _sort(v, i):
    """A warp's bitonic sort of 32 pairs, best first."""
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            v, i = _exchange(v, i, stride, ((LANES & stride) == 0)
                             == ((LANES & size) == 0))
            stride //= 2
        size *= 2
    return v, i


def _merge_into(av, ai, bv, bi):
    """The better 32 of two sorted lists: the elementwise better of a and b
    reversed, then a bitonic merge."""
    rv, ri = bv[31 - LANES], bi[31 - LANES]
    b = _beats(rv, ri, av, ai)
    av, ai = np.where(b, rv, av), np.where(b, ri, ai)
    for stride in (16, 8, 4, 2, 1):
        av, ai = _exchange(av, ai, stride, (LANES & stride) == 0)
    return av, ai


def _rank_merge(lv, li, cv, cj):
    """The passing columns packed into lanes 0 .. n - 1 (pads after), each
    broadcast in turn: a list slot moves down by the columns better than
    it, a column goes to its rank in the list plus the columns better than
    it; slots past 31 drop out."""
    lpos, cpos = LANES.copy(), np.zeros(32, np.int64)
    for b in range(int((cj != PAD[1]).sum())):
        lpos += _beats(cv[b], cj[b], lv, li)
        cpos += _beats(cv[b], cj[b], cv, cj)
        cpos[b] += int(_beats(lv, li, cv[b], cj[b]).sum())
    nv = np.full(32, np.float32(np.nan), np.float32)
    ni = np.full(32, -1, np.int64)
    for pos, v, i in list(zip(lpos, lv, li)) + [
            (cpos[b], cv[b], cj[b]) for b in range(32) if cj[b] != PAD[1]]:
        if pos < 32:
            assert ni[pos] == -1          # the new slots are a permutation
            nv[pos], ni[pos] = v, i
    assert (ni != -1).all()
    return nv, ni


def _select_row(lv, li, v128, j128, N, k):
    """csrc/sketch.cu::select_row on one row's 128 columns of a tile."""
    tv, ti = lv[k - 1], li[k - 1]
    ok = (j128 < N) & _beats(v128, j128, tv, ti)
    n = int(ok.sum())
    if n == 0:
        return lv, li
    gv = np.where(ok, v128, PAD[0]).astype(np.float32)
    gj = np.where(ok, j128, PAD[1])
    if n <= 32:
        cv = np.full(32, PAD[0], np.float32)
        cj = np.full(32, PAD[1], np.int64)
        cv[:n], cj[:n] = gv[ok], gj[ok]
        return _rank_merge(lv, li, cv, cj)
    g = [_sort(gv[32 * c:32 * c + 32], gj[32 * c:32 * c + 32])
         for c in range(4)]
    g[0] = _merge_into(*g[0], *g[1])
    g[2] = _merge_into(*g[2], *g[3])
    g[0] = _merge_into(*g[0], *g[2])
    return _merge_into(lv, li, *g[0])


def _first_pass_emulated(scores, k, nseg):
    """The tile kernel's lists: per row and segment, its tiles in order."""
    n = scores.shape[1]
    pad_cols = -(-n // sk.TILE) * sk.TILE
    s = np.zeros((scores.shape[0], pad_cols), np.float32)
    s[:, :n] = scores
    cols = np.arange(pad_cols)
    bounds = sk.segment_bounds(n, nseg)
    vals = np.empty((scores.shape[0], nseg, k), np.float32)
    idx = np.empty((scores.shape[0], nseg, k), np.int64)
    for r in range(scores.shape[0]):
        for g, (c0, c1) in enumerate(bounds):
            lv = np.full(32, PAD[0], np.float32)
            li = np.full(32, PAD[1], np.int64)
            for j0 in range(c0, c1, sk.TILE):
                lv, li = _select_row(lv, li, s[r, j0:j0 + sk.TILE],
                                     cols[j0:j0 + sk.TILE], n, k)
            vals[r, g], idx[r, g] = lv[:k], li[:k]
    return vals, idx


def _merge_emulated(vals, idx, k):
    """csrc/sketch.cu::sketch_merge_kernel: lane s holds list s's head."""
    rows, nseg, _k = vals.shape
    out_v = np.empty((rows, k), np.float32)
    out_i = np.empty((rows, k), np.int64)
    for r in range(rows):
        h = np.zeros(32, np.int64)
        for step in range(k):
            hv = np.array([vals[r, s, h[s]] if s < nseg and h[s] < k
                           else PAD[0] for s in range(32)], np.float32)
            hi = np.array([idx[r, s, h[s]] if s < nseg and h[s] < k
                           else PAD[1] for s in range(32)], np.int64)
            bv, bi = hv.copy(), hi.copy()
            for off in (16, 8, 4, 2, 1):
                ov, oi = bv[LANES ^ off], bi[LANES ^ off]
                t = _beats(ov, oi, bv, bi)
                bv, bi = np.where(t, ov, bv), np.where(t, oi, bi)
            assert (bv == bv[0]).all() and (bi == bi[0]).all()
            out_v[r, step], out_i[r, step] = bv[0], bi[0]
            h[(LANES < nseg) & (hi == bi[0]) & (hv == bv[0])
              & (bi[0] != PAD[1])] += 1
    return out_v, out_i


@pytest.mark.parametrize("kind,n,k", [
    ("integer_ties", 2, 1), ("integer_ties", 21, 20), ("equal_rows", 129, 20),
    ("diagonal", 300, 20), ("signed_zero", 300, 32), ("integer_ties", 260, 1),
    ("sketch", 300, 20)])
def test_kernel_selection_emulated_equals_plain(kind, n, k):
    """Every segment count the kernel takes at this n: the emulated lists
    equal segment_topn_plain's, and their emulated merge merge_topn_plain's
    and topn's."""
    if kind == "sketch":
        prof, lens = _square_profiles(n, seed=5)
        scores = sk.sketch_scores_plain(torch.sqrt(torch.from_numpy(prof)),
                                        torch.from_numpy(lens), 0, n).numpy()
    else:
        scores = _given_scores(kind, n, seed=n + k)
    rows = scores if n <= 150 else scores[::7]       # keep the run short
    want_v, want_i = (x.numpy() for x in sk.topn(torch.from_numpy(rows), k))
    for nseg in range(1, -(-n // sk.TILE) + 1):
        ev, ei = _first_pass_emulated(rows, k, nseg)
        pv, pi = sk.segment_topn_plain(torch.from_numpy(rows), k,
                                       sk.segment_bounds(n, nseg))
        assert np.array_equal(_bits(ev), _bits(pv.numpy())), nseg
        assert np.array_equal(ei, pi.numpy()), nseg
        mv, mi = _merge_emulated(ev, ei, k)
        assert np.array_equal(_bits(mv), _bits(want_v)), nseg
        assert np.array_equal(mi, want_i), nseg
