"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and, but for the build table's tests,
skips itself without a CUDA device; run them on a machine with an sm_90a
card and nvcc:

    python -m pytest -m cuda tests/test_torch_*.py

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  Tolerance: exact (integer DP outputs).
"""
import random

import numpy as np
import pytest
import torch

from isocon_tpu_torch.ops import _build
from isocon_tpu_torch.ops import affine as ta
from isocon_tpu_torch.ops import affine_cuda as tac
from isocon_tpu_torch.ops import myers as tm
from isocon_tpu_torch.ops import sketch as tsk
from isocon_tpu_torch.ops import wavefront as tw
from isocon_tpu_torch.ops.engine import PairEngine, pool_from_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _plain_cpu_engines(monkeypatch):
    """CPU engines here keep the plain K1/K2/K5 (``ISOCON_NO_NATIVE=1``),
    which the card's kernels are held to; a card engine never takes the
    host route."""
    monkeypatch.setenv("ISOCON_NO_NATIVE", "1")

_ALPHA = np.array([0, 1, 2, 3, 5], np.int8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _code_pairs(seed, B, L):
    """Seeded code pairs: random substitutions/indels up to 40%, N codes,
    length deltas up to 300."""
    rs = np.random.default_rng(seed)
    q = np.full((B, L), 6, np.int8)
    t = np.full((B, L), 6, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rs.integers(50, L + 1))
        a = rs.choice(_ALPHA, size=n)
        keep = rs.random(n) >= rs.uniform(0, 0.4)
        o = np.where(rs.random(n) < 0.1, rs.choice(_ALPHA, size=n), a)[keep]
        d = int(rs.integers(-300, 301))
        o = (np.concatenate([o, rs.choice(_ALPHA, size=d)]) if d > 0
             else o[:max(1, o.size + d)])[:L]
        q[b, :n] = a
        t[b, :o.size] = o
        ql[b], tl[b] = n, o.size
    return q, t, ql, tl


def test_build_table_lists_every_kernel():
    """Needs no card: every source has its file, every C entry point a
    signature, and every kernel a launch counter."""
    import os

    assert _build.SOURCES == ("myers_ed", "affine_sg", "wavefront_ed",
                              "sketch", "consensus")
    for name in _build.SOURCES:
        assert os.path.exists(os.path.join(_build.CSRC, name + ".cu"))
    assert set(_build._SIGNATURES) == {
        "isocon_myers_ed", "isocon_myers_hw", "isocon_affine_fwd",
        "isocon_affine_walk", "isocon_wavefront_ed", "isocon_sketch_scores",
        "isocon_sketch_topn", "isocon_sketch_merge", "isocon_kmer_profile",
        "isocon_consensus_vote", "isocon_consensus_correct"}
    assert len(_build._SIGNATURES["isocon_wavefront_ed"]) == 17
    assert len(_build._SIGNATURES["isocon_sketch_scores"]) == 11
    assert len(_build._SIGNATURES["isocon_sketch_topn"]) == 10
    assert len(_build._SIGNATURES["isocon_sketch_merge"]) == 8
    with open(os.path.join(_build.CSRC, "sketch.cu")) as fh:
        src = fh.read()
    for entry in ("scores", "topn", "merge"):
        assert "ISOCON_API int isocon_sketch_%s(" % entry in src
    # K7 beside K6, its kernel's name without the "sketch_" that the
    # benchmark's sketch_roofline reads
    assert "ISOCON_API int isocon_kmer_profile(" in src
    assert "kmer_profile_kernel(" in src
    assert len(_build._SIGNATURES["isocon_kmer_profile"]) == 5
    assert len(_build._SIGNATURES["isocon_affine_fwd"]) == 20
    assert len(_build._SIGNATURES["isocon_affine_walk"]) == 25
    with open(os.path.join(_build.CSRC, "wavefront_ed.cu")) as fh:
        assert "ISOCON_API int isocon_wavefront_ed(" in fh.read()
    with open(os.path.join(_build.CSRC, "consensus.cu")) as fh:
        src = fh.read()
    for entry in ("vote", "correct"):
        assert "ISOCON_API int isocon_consensus_%s(" % entry in src
    assert len(_build._SIGNATURES["isocon_consensus_vote"]) == 10
    assert len(_build._SIGNATURES["isocon_consensus_correct"]) == 13
    assert set(_build.LAUNCHES) == {"myers_ed", "myers_hw", "affine_fwd",
                                    "affine_walk", "wavefront_ed",
                                    "sketch_scores", "sketch_topn",
                                    "sketch_merge", "kmer_profile",
                                    "consensus_vote", "consensus_correct"}
    _build.LAUNCHES["wavefront_ed"] += 1
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("win", [7, 9, 17, 33, None])
def test_myers_kernel_matches_plain(win):
    dev = _card()
    Lp, B = 1024, 512
    Lk = Lp if win is None else max(Lp, 32 * win)
    q, t, ql, tl = _code_pairs(1, B, Lp)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), Lp, dev)
    peq = tm.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["myers_ed"]
    got = tm.myers_ed_pool(pool, plen, peq, ia, ia + B, L=Lk, win=win)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["myers_ed"] == before + 1
    qrow, trow, n, m = tm._swap(plen, ia.long(), (ia + B).long())
    want = tm.myers_ed_plain(peq[qrow], pool[trow], n, m, L=Lk,
                             win=Lk // 32 if win is None else win)
    assert torch.equal(got, want)


def _hw_code_pairs(seed, B, L):
    """Seeded infix pairs: exact and mutated substrings, queries longer
    than the target, unrelated pairs and queries of 1-11 codes."""
    rs = np.random.default_rng(seed)
    q = np.full((B, L), 6, np.int8)
    t = np.full((B, L), 6, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rs.integers(L // 3, L - 40))
        tgt = rs.choice(_ALPHA, size=m)
        mode = b % 5
        lo, hi = sorted(int(x) for x in rs.integers(0, m, 2))
        if mode == 0:
            a = tgt[lo:hi + 1]
        elif mode == 1:
            a = tgt[lo:hi + 1].copy()
            hit = rs.random(a.size) < 0.05
            a[hit] = rs.choice(_ALPHA, size=int(hit.sum()))
            a = a[rs.random(a.size) >= 0.03]
        elif mode == 2:
            a = np.concatenate([tgt, rs.choice(_ALPHA,
                                               size=int(rs.integers(1, 40)))])
        elif mode == 3:
            a = rs.choice(_ALPHA, size=int(rs.integers(40, L)))
        else:
            a = rs.choice(_ALPHA, size=int(rs.integers(1, 12)))
        if a.size == 0:
            a = tgt[:5]
        q[b, :a.size] = a
        t[b, :m] = tgt
        ql[b], tl[b] = a.size, m
    return q, t, ql, tl


@pytest.mark.parametrize("win", [7, 9, 17, 33, None])
def test_myers_hw_kernel_matches_plain(win):
    dev = _card()
    Lp, B = 1024, 512
    Lk = Lp if win is None else max(Lp, 32 * win)
    q, t, ql, tl = _hw_code_pairs(2, B, Lp)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), Lp, dev)
    peq = tm.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    before = dict(_build.LAUNCHES)
    ed, ej = tm.myers_hw_pool(pool, plen, peq, ia, ia + B, L=Lk, win=win)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["myers_hw"] == before["myers_hw"] + 1
    assert _build.LAUNCHES["myers_ed"] == before["myers_ed"]
    n, m = plen[ia.long()], plen[(ia + B).long()]
    wed, wej = tm.myers_hw_plain(peq[ia.long()], pool[(ia + B).long()], n, m,
                                 L=Lk, win=Lk // 32 if win is None else win,
                                 full=win is None)
    assert torch.equal(ed, wed) and torch.equal(ej, wej)
    assert bool((n > m).any())
    if win == 7:        # a short unrelated query: the empty span wins
        assert bool((ej == 0).any())


@pytest.mark.parametrize("win", [7, 9, 17, 33])
def test_myers_hw_kernel_warp_kinds(win):
    """K2 against its plain version on every entry, at each window, in
    warps of every kind of ``chip_smoke.hw_warp_pairs`` three times over
    and a last warp of 5 lanes (B = 32 x 18 + 5): warps of one query whose
    lanes walk in the same phases, warps of mixed queries, queries longer
    than their target by more than 128 (no column can set the minimum, the
    lane sweeps nothing), queries of 1-32 codes against targets of 0 and 1,
    lengths 0, 1 and L, and lanes that end many phases before the rest of
    their warp."""
    import chip_smoke

    dev = _card()
    Lp = Lk = 2048
    q, t, ql, tl = chip_smoke.hw_warp_pairs(
        np, Lp, kinds=chip_smoke.HW_WARP_KINDS * 3, seed=20 + win)
    B = q.shape[0]
    assert B % 32 == 5
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), Lp, dev)
    peq = tm.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["myers_hw"]
    ed, ej = tm.myers_hw_pool(pool, plen, peq, ia, ia + B, L=Lk, win=win)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["myers_hw"] == before + 1
    n, m = plen[ia.long()], plen[(ia + B).long()]
    wed, wej = tm.myers_hw_plain(peq[ia.long()], pool[(ia + B).long()], n, m,
                                 L=Lk, win=win)
    assert torch.equal(ed, wed) and torch.equal(ej, wej)
    n, m = torch.from_numpy(ql), torch.from_numpy(tl)
    assert bool(((n == 0) | (m == 0)).any()) and bool((n == Lp).any())
    assert bool((n > m + 128).any())
    cols = chip_smoke.myers_columns(n, m, win, True, Lk)
    assert bool((cols == 0).any()) and chip_smoke.warp_balance(cols) < 0.75
    fired, phases = chip_smoke.hw_vote_share(n, m, win, Lk)
    assert 0 < fired < phases


def _phase_crossing_pairs(seed, B, L):
    """Pairs whose sweeps end in every kind of phase of the band kernel at
    width L: inside the head phases (<= 96 columns), across head -> steady,
    and across steady -> tail (lengths near L, where the window clips), with
    N and X codes, n = m, n = 1 and unrelated targets; every third row holds
    matching codes past its length."""
    rs = np.random.default_rng(seed)
    alpha = np.array([0, 1, 2, 3, 5, 4], np.int8)
    q = np.full((B, L), 6, np.int8)
    t = np.full((B, L), 6, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        kind = b % 4
        lo, hi = ((1, 96), (97, L - 200), (L - 200, L), (1, L))[kind]
        n = 1 if b % 29 == 0 else int(rs.integers(lo, hi + 1))
        m = n if b % 13 == 0 else int(rs.integers(lo, hi + 1))
        a = rs.choice(alpha, size=n, p=[.22, .22, .22, .22, .08, .04])
        o = np.concatenate([a, rs.choice(alpha, size=max(m - n, 0))])[:m]
        hit = rs.random(m) < rs.uniform(0, 0.3)
        o[hit] = rs.choice(alpha, size=int(hit.sum()))
        if b % 11 == 5:
            o = rs.choice(alpha, size=m)
        q[b, :n], t[b, :m] = a, o
        if b % 3 == 1:
            q[b, n:] = rs.integers(0, 4, size=L - n)
            t[b, m:] = rs.integers(0, 4, size=L - m)
        ql[b], tl[b] = n, m
    return q, t, ql, tl


@pytest.mark.parametrize("hw", [False, True], ids=["nw", "hw"])
@pytest.mark.parametrize("win", [7, 33])
def test_myers_band_kernel_phase_crossings(win, hw):
    """K1 / K2's band kernel against its plain version on every entry, on a
    ragged batch whose pairs end in head phases (W0 = 0), cross head ->
    steady (W0 = p - HALF) and steady -> tail (W0 = nwords - WIN), or stop
    where the window has moved below row n."""
    dev = _card()
    L, B = 1536, 997
    q, t, ql, tl = _phase_crossing_pairs(7 + win, B, L)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), L, dev)
    peq = tm.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    ib = ia + B
    if hw:
        got = tm.myers_hw_pool(pool, plen, peq, ia, ib, L=L, win=win)
        n, m = plen[ia.long()], plen[ib.long()]
        want = tm.myers_hw_plain(peq[ia.long()], pool[ib.long()], n, m, L=L,
                                 win=win)
        last = torch.maximum(n, m)
    else:
        got = (tm.myers_ed_pool(pool, plen, peq, ia, ib, L=L, win=win),)
        qrow, trow, n, m = tm._swap(plen, ia.long(), ib.long())
        want = (tm.myers_ed_plain(peq[qrow], pool[trow], n, m, L=L,
                                  win=win),)
        last = m
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    half, nwords = win // 2, L // 32
    nword = torch.div(n.long() - 1, 32, rounding_mode="floor")
    stop = torch.where(nwords - win > nword, nword + half + 1,
                       torch.full_like(nword, nwords))
    phases = torch.minimum((last.long() + 31) // 32, stop)   # the kernel's
    assert bool((phases <= half).any())                   # head only
    assert bool(((phases > half + 1)
                 & (phases <= nwords - win + half)).any())  # into steady
    assert bool((phases > nwords - win + half + 1).any())  # into the tail


def _affine_inputs(seed, B, L, dev):
    rs = np.random.default_rng(seed)
    q = np.full((B, L), 6, np.int8)
    t = np.full((B, L), 6, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rs.integers(300, L - 300))
        a = rs.choice(_ALPHA[:4], size=n)
        if b % 4 == 0:      # overlap on the edge of the 256 band
            o = np.concatenate([rs.choice(_ALPHA[:4], size=128), a[:n - 128]])
        else:
            o = np.where(rs.random(n) < 0.05, rs.choice(_ALPHA[:4], size=n),
                         a)[rs.random(n) >= 0.03]
        q[b, :n] = a
        t[b, :o.size] = o
        ql[b], tl[b] = n, o.size
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), L, dev)
    k = torch.arange(B, device=dev)
    ia = k.to(torch.int32)
    mi = torch.tensor([-1, -2, -4], dtype=torch.int32, device=dev)[k % 3]
    full = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)
    return pool, plen, ia, ia + B, full(2), mi, full(2), (k % 2).to(
        torch.int32)


@pytest.mark.parametrize("Wp", [256, 512, 1024, 2048])
def test_affine_kernels_match_plain(Wp):
    """K3 (the register kernel at 256 .. 1024, the block kernel at 2048)
    and K4 against their plain versions on every entry."""
    dev = _card()
    pool, plen, ia, ib, ma, mi, go, ge = _affine_inputs(5, 128, 1024, dev)
    got = tac.sg_align_pool(pool, plen, ia, ib, ma, mi, go, ge, Wp=Wp)
    torch.cuda.synchronize()
    n, m = plen[ia.long()], plen[ib.long()]
    best, ei, ej, dirs = ta.sg_forward_plain(pool[ia.long()], pool[ib.long()],
                                             n, m, ma, mi, go, ge, Wp)
    ops, fi, fj, ov = ta.sg_walk_plain(dirs, ei, ej, Wp,
                                       int((n + m).max()) + 1)
    for g, w in zip(got, (best, ei, ej, ops, fi, fj, ov)):
        assert torch.equal(g, w)
    if Wp == 256:
        assert bool(got[6].any())


def _affine_ragged_pairs(seed, B, L, Wp):
    """Pairs of lengths 0, 1, 40, L and any in turn, each length with each
    kind: noisy copies, t ahead of q and q ahead of t by an offset at the
    band's edge (one sequence ending first, or well first: the endpoint on
    column m or row n where it enters the band), identical pairs, unrelated
    pairs (endpoint ties) and offsets outside the band (overflow)."""
    rs = np.random.default_rng(seed)
    q = np.full((B, L), 6, np.int8)
    t = np.full((B, L), 6, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    W = Wp // 2
    rand = lambda k: rs.choice(_ALPHA[:4], size=k)
    for b in range(B):
        n = (0, 1, 40, L, int(rs.integers(2, L)))[b % 5]
        a = rand(n)
        kind = (b // 5) % 6
        P = W - 3 + b % 7                 # an offset at the band's edge
        cut = 20 + b % 2 * (W + 20)       # t (q) ends first, or well first
        if kind == 0:
            o = np.where(rs.random(n) < 0.03, rand(n), a)[rs.random(n) >= 0.02]
        elif kind == 1:
            o = np.concatenate([rand(P), a[:max(0, n - cut)]])
        elif kind == 2:
            o = np.concatenate([a[P:], rand(cut)])
        elif kind == 3:
            o = a.copy()
        elif kind == 4:
            o = rs.choice(_ALPHA, size=int(rs.integers(0, L + 1)))
        else:
            o = np.concatenate([rand(W + 10 + b % 50), a])
            if b % 2:
                a, o = o, a
        a, o = a[:L], o[:L]
        q[b, :a.size] = a
        t[b, :o.size] = o
        ql[b], tl[b] = a.size, o.size
    return q, t, ql, tl


@pytest.mark.parametrize("Wp", [256, 512, 1024])
def test_affine_register_kernel_ragged_batch(Wp):
    """K3's register kernel and K4 against their plain versions on every
    entry of four launches back to back: one warp a pair on more pairs than
    the persistent grid can have warps (an SM holds at most 64), so each
    warp takes several pairs of very different lengths in turn, then once
    more on fewer (the pair counter is zeroed for each launch); four warps
    a pair (B <= 2 SMs) on 151 and 100 pairs.  Then each form forced at a
    launch size that would choose the other: four warps a pair on 453
    pairs, one warp on 151 and 100."""
    dev = _card()
    L, B0 = (1504 if Wp == 1024 else 1200), 151
    q, t, ql, tl = _affine_ragged_pairs(Wp, B0, L, Wp)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), L, dev)
    k = torch.arange(B0, device=dev)
    ma = torch.full((B0,), 2, dtype=torch.int32, device=dev)
    mi = torch.tensor([-1, -2, -4], dtype=torch.int32, device=dev)[k % 3]
    go = torch.tensor([2, 3], dtype=torch.int32, device=dev)[k % 2]
    ge = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)[k % 3]
    n, m = plen[:B0], plen[B0:]
    best, ei, ej, dirs = ta.sg_forward_plain(pool[:B0], pool[B0:], n, m, ma,
                                             mi, go, ge, Wp)
    want = (best, ei, ej) + ta.sg_walk_plain(dirs, ei, ej, Wp,
                                             int((n + m).max()) + 1)
    assert bool(want[6].any()) and bool((want[0] == 0).any())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert B0 <= 2 * sms < 3 * B0
    for B, warps in ((64 * sms + B0, 0), (3 * B0, 0), (B0, 0), (100, 0),
                     (3 * B0, 4), (B0, 1), (100, 1)):
        idx = (torch.arange(B, device=dev) * 7) % B0   # every pair, mixed
        before = _build.LAUNCHES["affine_fwd"]
        if warps:
            best, ei, ej, dirs = tac.affine_fwd_cuda(
                pool, idx, idx + B0, n[idx], m[idx], ma[idx], mi[idx],
                go[idx], ge[idx], Wp=Wp, warps=warps)
            got = (best, ei, ej) + tac.affine_walk(
                dirs, ei, ej, Wp=Wp, nops=int((n[idx] + m[idx]).max()) + 1,
                seqs=(pool, idx, idx + B0, n[idx], m[idx]))
        else:
            got = tac.sg_align_pool(pool, plen, idx, idx + B0, ma[idx],
                                    mi[idx], go[idx], ge[idx], Wp=Wp)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["affine_fwd"] == before + 1
        for g, w in zip(got, want):
            w = w[idx]
            if g.dim() == 2:    # ops: as wide as this batch's longest walk
                assert not w[:, g.shape[1]:].any()
                w = w[:, :g.shape[1]]
            assert torch.equal(g, w)


def _walk_pairs(seed, B, L, Wp):
    """Pairs for K4's tile crossings at band Wp (W = Wp/2 lanes): noisy
    copies; insertions of W bases in the target and of W - 1 in the query
    (the path runs on the band's last or first lane: the walk flags
    overflow and its tiles' lane windows are clipped at the band's edges);
    insertions of W/2 in either (a gap run of W/2 steps that crosses tiles
    inside the band); insertions of 2 W (longer than the band); short
    queries of 0, 1 and 40 codes; unrelated pairs."""
    rs = np.random.default_rng(seed)
    q = np.full((B, L), 6, np.int8)
    t = np.full((B, L), 6, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    W = Wp // 2
    rand = lambda k: rs.choice(_ALPHA[:4], size=k)
    for b in range(B):
        kind = b % 8
        n = int(rs.integers(L // 4, L // 2))
        a = rand(n)
        mid = n // 2
        ins = (0, W, W - 1, W // 2, W // 2, 2 * W, 0, 0)[kind]
        extra = rand(min(ins, L - n))
        if kind == 0:
            o = np.where(rs.random(n) < 0.03, rand(n), a)[rs.random(n) >= 0.02]
        elif kind in (1, 4, 5):
            o = np.concatenate([a[:mid], extra, a[mid:]])
        elif kind in (2, 3):
            o = a
            a = np.concatenate([a[:mid], extra, a[mid:]])
        elif kind == 6:
            o = a
            a = a[:(0, 1, 40)[b // 8 % 3]]
        else:
            o = rand(int(rs.integers(1, L)))
        q[b, :a.size] = a
        t[b, :o.size] = o
        ql[b], tl[b] = a.size, o.size
    return q, t, ql, tl


@pytest.mark.parametrize("Wp", [256, 1024, 2048])
def test_affine_walk_kernel_tile_crossings(Wp):
    """K4's walk against ``sg_walk_plain`` on every entry, on the direction
    bytes K3 writes (its register kernel at 256 and 1024, its block kernel
    at 2048) for ``_walk_pairs`` of up to 4096 codes: gap runs that cross
    many tiles, walks on both band edges, band overflow.  At band 256 also
    on a ragged batch of those walks larger than the persistent grid can
    hold (an SM holds at most 64 warps), so each warp walks several pairs
    of very different lengths in turn."""
    dev = _card()
    L, B0 = 4096, 24
    q, t, ql, tl = _walk_pairs(Wp, B0, L, Wp)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), L, dev)
    k = torch.arange(B0, device=dev)
    full = lambda v: torch.full((B0,), v, dtype=torch.int32, device=dev)
    mi = torch.tensor([-1, -2, -4], dtype=torch.int32, device=dev)[k % 3]
    ge = (k % 2).to(torch.int32)
    n, m = plen[:B0], plen[B0:]
    best, ei, ej, dirs = tac.affine_fwd(pool, k, k + B0, n, m, full(2), mi,
                                        full(2), ge, Wp=Wp)
    nops = int((n + m).max()) + 1
    want = ta.sg_walk_plain(dirs, ei, ej, Wp, nops)
    ov = want[3].cpu().numpy()
    assert ov[1::8].all() and ov[2::8].all() and not ov[::8].any()
    before = _build.LAUNCHES["affine_walk"]
    got = tac.affine_walk(dirs, ei, ej, Wp=Wp, nops=nops,
                          seqs=(pool, k, k + B0, n, m))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["affine_walk"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if Wp == 256:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        idx = (torch.arange(64 * sms + B0, device=dev) * 7) % B0
        got = tac.affine_walk(dirs[idx], ei[idx], ej[idx], Wp=Wp, nops=nops,
                              seqs=(pool, idx, idx + B0, n[idx], m[idx]))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w[idx])


def _rows_to_length(a1, a2, alen, nmat, nmis):
    """K4's rows with the bytes past each row's length (which the card
    leaves unwritten) zeroed, as ``sg_rows_plain`` gives them."""
    pos = torch.arange(a1.shape[1], device=a1.device)[None, :]
    keep = pos < alen.long()[:, None]
    return (torch.where(keep, a1, 0), torch.where(keep, a2, 0), alen, nmat,
            nmis)


def _long_walk_pairs(seed, B, L):
    """Pairs of 16.5-20 k codes in a pool of width L (32,768): noisy copies
    (a walk of some 36 k steps), copies with 60-base insertions on either
    side and with clipped ends (end gaps)."""
    rs = np.random.default_rng(seed)
    q = np.full((B, L), 6, np.int8)
    t = np.full((B, L), 6, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    rand = lambda k: rs.choice(_ALPHA, size=k)
    for b in range(B):
        n = int(rs.integers(16500, 20000))
        a = rand(n)
        o = np.where(rs.random(n) < 0.01, rand(n), a)[rs.random(n) >= 0.005]
        if b % 3 == 1:
            o = np.concatenate([o[:n // 3], rand(60), o[n // 3:]])
            a = np.concatenate([a[:2 * n // 3], rand(60), a[2 * n // 3:]])
        elif b % 3 == 2:
            o = o[int(rs.integers(1, 40)):o.size - int(rs.integers(1, 40))]
        q[b, :a.size] = a
        t[b, :o.size] = o
        ql[b], tl[b] = a.size, o.size
    return q, t, ql, tl


@pytest.mark.parametrize("case,Wp", [("tiles", 256), ("tiles", 512),
                                     ("tiles", 1024), ("tiles", 2048),
                                     ("ragged", 256), ("few", 256),
                                     ("long", 256)])
def test_affine_walk_rows_match_plain(case, Wp):
    """K4's epilogue against ``sg_rows_plain`` on the kernel's own walks:
    both rows byte for byte up to their length, their lengths, the matches
    and mismatches.  The walk's own outputs are ``sg_walk_plain``'s where
    that is cheap (L 4,096).
    ``tiles``: ``_walk_pairs`` (gap runs across tiles, both band edges,
    overflow, walks of thousands of steps over the 128-step ring);
    ``ragged``: the same walks, more pairs than the persistent grid holds
    warps, each warp walking several in turn; ``few``: a launch of three
    pairs; ``long``: six pairs of 16.5-20 k codes at L 32,768."""
    dev = _card()
    if case == "long":
        L, B0 = 32768, 6
        q, t, ql, tl = _long_walk_pairs(Wp, B0, L)
    else:
        L, B0 = 4096, 24
        q, t, ql, tl = _walk_pairs(Wp, B0, L, Wp)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), L, dev)
    k = torch.arange(B0, device=dev)
    full = lambda v: torch.full((B0,), v, dtype=torch.int32, device=dev)
    mi = torch.tensor([-1, -2, -4], dtype=torch.int32, device=dev)[k % 3]
    best, ei, ej, dirs = tac.affine_fwd(pool, k, k + B0, plen[:B0],
                                        plen[B0:], full(2), mi, full(2),
                                        (k % 2).to(torch.int32), Wp=Wp)
    idx = k
    if case == "ragged":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        idx = (torch.arange(64 * sms + B0, device=dev) * 7) % B0
    elif case == "few":
        idx = k[[5, 0, 17]]
    n, m = plen[idx], plen[B0 + idx]
    nops = int((n + m).max()) + 1
    seqs = (pool, idx, B0 + idx, n, m)
    before = _build.LAUNCHES["affine_walk"]
    got = tac.affine_walk(dirs[idx], ei[idx], ej[idx], Wp=Wp, nops=nops,
                          seqs=seqs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["affine_walk"] == before + 1
    assert len(got) == 9
    if case != "long":
        for g, w in zip(got, ta.sg_walk_plain(dirs[idx], ei[idx], ej[idx],
                                              Wp, nops)):
            assert torch.equal(g, w)
    ops, fi, fj, ov = got[:4]
    want = ta.sg_rows_plain(ops, ei[idx], ej[idx], fi, fj, ov,
                            pool[idx], pool[B0 + idx], n, m, nops - 1)
    for g, w in zip(_rows_to_length(*got[4:]), want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    alen = got[6]
    assert bool((alen > 0).any())
    if case == "tiles":
        assert bool(ov.any()) and bool((alen[ov] == 0).all())
        assert int((ops != 0).sum(1).max()) > 4 * 128   # the ring turns
    if case == "long":
        assert int((alen > 16000).sum()) >= 4


def _wavefront_code_pairs(seed, B, L):
    """``_code_pairs`` plus what the wavefront's edge rules see: infix
    pairs, queries far longer than their target, lengths 0 and 1."""
    q, t, ql, tl = _code_pairs(seed, B, L)
    hq, ht, hql, htl = _hw_code_pairs(seed + 1, B, L)
    q, t = np.concatenate([q, hq]), np.concatenate([t, ht])
    ql, tl = np.concatenate([ql, hql]), np.concatenate([tl, htl])
    for b, (n, m) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1), (0, 40),
                                (40, 0), (1, 90), (L, 1)]):
        ql[b], tl[b] = n, m
    return q, t, ql, tl


def test_smoke_reads_register_kernel_report():
    """Needs no card: ``chip_smoke.py`` reads the kernel, band, mode,
    registers and spills of each instantiation of K3's and K5's register
    kernels from ptxas' report, and nothing of the other kernels."""
    import chip_smoke

    spill = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    entry = "\n".join([
        "== wavefront_ed ==",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_121wavefront"
        "_warp_kernelILi4ELb1EEEvPKhPKi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL__N_1",
        "    " + spill,
        "ptxas info    : Used 72 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_121wavefront"
        "_wide_kernelILb0EEEvPKhPKi' for 'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 32 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_121wavefront"
        "_warp_kernelILi2ELb0EEEvPKhPKi' for 'sm_90a'",
        "    16 bytes stack frame, 16 bytes spill stores, 28 bytes spill "
        "loads",
        "ptxas info    : Used 40 registers, used 0 barriers"])
    affine = "\n".join([
        "== affine_sg ==",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_117affine"
        "_fwd_kernelILi4EEEvPKhPKi' for 'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 30 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_118affine"
        "_warp_kernelILi16ELi1EEEvPKhPKi' for 'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 168 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_118affine"
        "_warp_kernelILi1ELi4EEEvPKhPKi' for 'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 40 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_118affine"
        "_warp_kernelILi4ELi1EEEvPKhPKi' for 'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 64 registers, used 0 barriers"])
    other = "== myers_ed ==\nptxas info    : Used 64 registers"
    assert chip_smoke.register_kernel_report([other, entry, affine]) == [
        ("K3 Wp 256, warps a pair: 1", 64, spill),
        ("K3 Wp 256, warps a pair: 4", 40, spill),
        ("K3 Wp 1024, warps a pair: 1", 168, spill),
        ("K5 Wp 128 NW", 40, "16 bytes stack frame, 16 bytes spill stores, "
         "28 bytes spill loads"),
        ("K5 Wp 256 HW", 72, spill)]


def test_smoke_reads_walk_kernel_report():
    """Needs no card: ``chip_smoke.py`` (and ``tools/kernel_time.py``)
    report the registers and spills of K4's walk kernel, one line per tile
    size, beside K3's register kernels."""
    import chip_smoke

    spill = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    affine = "\n".join([
        "== affine_sg ==",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_118affine"
        "_walk_kernelILi64EEEvPKhPKiS4_PhPiS6_S6_S6_iiii' for 'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 38 registers, used 0 barriers, 21504 bytes smem",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_118affine"
        "_warp_kernelILi4ELi1EEEvPKhPKi' for 'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 64 registers, used 0 barriers"])
    assert chip_smoke.register_kernel_report([affine]) == [
        ("K3 Wp 256, warps a pair: 1", 64, spill),
        ("K4 rows 64 a tile", 38, spill)]


def test_smoke_reads_myers_band_kernel_report():
    """Needs no card: ``chip_smoke.py`` (and ``tools/kernel_time.py``)
    report the registers and spills of K1's and K2's band kernel, one line
    per window and mode, and nothing of the full-width kernel."""
    import chip_smoke

    spill = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    entry = "\n".join([
        "== myers_ed ==",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_117myers"
        "_full_kernelILb1EEEvPKhPKjPKiS6_S6_S6_PiS7_ii' for 'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 40 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_117myers"
        "_band_kernelILi33ELi32ELb1EEEvPKhPKjPKiS6_S6_S6_PiS7_iii' for "
        "'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 128 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_117myers"
        "_band_kernelILi7ELi128ELb0EEEvPKhPKjPKiS6_S6_S6_PiS7_iii' for "
        "'sm_90a'",
        "    " + spill,
        "ptxas info    : Used 48 registers, used 0 barriers"])
    assert chip_smoke.register_kernel_report([entry]) == [
        ("K1 win 7", 48, spill), ("K2 win 33", 128, spill)]


def test_smoke_myers_work_counts_fused_forms(monkeypatch):
    """Needs no card: K1's operations are the fused word step times the
    window plus the column's Peq slot, over the columns a pair needs: up to
    m, or up to J* = 32 (nword + HALF + 1) where the window moves below row
    n; K2's up to m likewise (none where m < jlow, which fixes its answer),
    plus its walk on the columns where row n's word is in the window (from
    phase nword - HALF once nword >= WIN).
    They are counted in ALU lanes: the ALU-only operations, or half of all
    where that is more (the ALU and FMA pipes take 128 lanes together)."""
    import chip_smoke as cs

    assert (cs.MYERS_ALU_OPS_PER_WORD, cs.MYERS_ANY_OPS_PER_WORD) == (8, 4)
    alu_col = 7 * cs.MYERS_ALU_OPS_PER_WORD
    n = torch.tensor([100, 40, 400, 0], dtype=torch.int32)
    m = torch.tensor([130, 40, 900, 7], dtype=torch.int32)
    # nword 3, 1, 12, -1: the third stops at 32 * (12 + 4) = 512, the
    # empty query sweeps nothing
    assert cs.myers_work(n, m, 7, False) == (130 + 40 + 512) * alu_col
    # the window never moves below row n at L = 448 (nwords 14 - 7 <= 12)
    assert cs.myers_work(n, m, 7, False, L=448) == (130 + 40 + 900) * alu_col
    # K2 sweeps to m, or nothing where m < jlow = max(n - 32 HALF, 1): on
    # (query 900, target 400) jlow is 804, so nothing; on (900, 850) to
    # 850, walking from phase nword - HALF = 25 (nword 28); on (100, 130)
    # to 130, in the window from phase 0
    q = torch.tensor([900, 900, 100], dtype=torch.int32)
    t = torch.tensor([400, 850, 130], dtype=torch.int32)
    walk = cs.MYERS_HW_WALK_ALU_OPS_PER_COLUMN
    assert cs.myers_work(q, t, 7, True) == (
        (850 + 130) * alu_col + (850 - 32 * 25 + 130) * walk)
    # where the operations either pipe takes dominate, half of all counts
    monkeypatch.setattr(cs, "MYERS_ALU_OPS_PER_WORD", 1)
    monkeypatch.setattr(cs, "MYERS_ANY_OPS_PER_WORD", 11)
    assert cs.myers_work(n, m, 7, False) == (130 + 40 + 512) * (
        7 * (1 + 11) + cs.MYERS_ANY_OPS_PER_COLUMN) / 2


def test_smoke_warp_balance_counts_the_longest_lane():
    """Needs no card: a warp of 32 consecutive pairs runs until its longest
    pair's last phase of 32 columns; the balance is the share of those
    issue slots the lanes use, and a ragged last warp counts its empty
    lanes."""
    import chip_smoke as cs

    assert cs.warp_balance(torch.full((64,), 100)) == 1.0
    assert cs.warp_balance(torch.tensor([32] * 31 + [64])) == \
        pytest.approx(33 / 64)
    assert cs.warp_balance(torch.tensor([5] * 40)) == pytest.approx(40 / 64)
    cols = cs.myers_columns(torch.tensor([400, 0]), torch.tensor([900, 7]),
                            7, False)
    assert cols.tolist() == [512, 0]


def test_sass_loops_counts_each_loop():
    """Needs no card: ``tools/sass_loops.py`` finds each backward branch of
    a function in ``cuobjdump -sass`` output (label or address targets),
    counts the opcodes from its target to it and the loops it holds."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "sass_loops.py")
    spec = importlib.util.spec_from_file_location("sass_loops", path)
    sl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sl)
    sass = "\n".join([
        "\t\tFunction : _ZN4_GLOBAL__N_117myers_band_kernelILi7E",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        ".L_x_1:",
        "        /*0010*/                   LDS R2, [R3] ;",
        "        /*0020*/                   LOP3.LUT R4, R2, R5, RZ, 0xfc, "
        "!PT ;",
        "        /*0030*/               @P0 SHF.L.W.U32.HI R6, R4, 0x1, R7 ;",
        "        /*0040*/              @!P1 BRA `(.L_x_1) ;",
        "        /*0050*/                   IADD3 R8, R8, 0x1, RZ ;",
        "        /*0060*/                   BRA 0x10 ;",
        "        /*0070*/                   EXIT ;"])
    funcs, labels = sl.parse(sass)
    (name, insns), = funcs.items()
    rep = sl.report(insns, labels[name])
    assert rep["instructions"] == 8
    inner, outer = rep["loops"]
    assert (inner["start"], inner["end"], inner["instructions"]) == (
        "0010", "0040", 4)
    assert inner["opcodes"] == {"LDS": 1, "LOP3": 1, "SHF": 1, "BRA": 1}
    assert (outer["instructions"], outer["inner_loops"]) == (6, 1)


def test_smoke_walk_bound_counts_the_chain():
    """Needs no card: K4's bound is the largest of its bytes, its
    operations and the chain of its longest walk, steps x
    ``SHARED_LOAD_CYCLES`` at the SM clock; a kernel without a chain keeps
    the larger of the first two."""
    import chip_smoke as cs

    ms, by = cs.bound_ms(1e6, 1e6, 1980.0, 36500)
    assert by == "chain"
    assert ms == pytest.approx(36500 * cs.SHARED_LOAD_CYCLES / 1980e6 * 1e3)
    assert 0.5 < ms < 0.6
    assert cs.bound_ms(3.35e9, 1e6, 1980.0) == (pytest.approx(1.0), "bytes")
    assert cs.bound_ms(3.35e9, 1e6, 1980.0, 10)[1] == "bytes"
    ops = 132 * 64 * 1980e6 * 1e-3          # one ms of int32 operations
    assert cs.bound_ms(1.0, ops, 1980.0, 10) == (pytest.approx(1.0),
                                                 "operations")


def test_smoke_k3_mean_launch_batch_is_the_table_batch_prefix():
    """Needs no card: ``chip_smoke.py`` holds K3 at the runs' mean launch
    sizes to its own result on the first pairs of the table shapes' batch,
    and ``tools/kernel_time.py`` times the mean launches on ``k3_batch`` of
    that size: the two are the same pairs with the same scores."""
    import chip_smoke

    big = chip_smoke.k3_batch(torch, np, "cpu", 1200)
    small = chip_smoke.k3_batch(torch, np, "cpu", 917)
    assert torch.equal(big[0], small[0])
    for x, y in zip(big[1:], small[1:]):
        assert torch.equal(x[:917], y)
    pool = big[0]
    plen = torch.arange(pool.shape[0], dtype=torch.int32)
    qrow = torch.tensor([5, 9, 2, 7, 1, 3])
    chunk = (pool, plen, qrow, qrow + 512)
    long_batch = chip_smoke.k3_batch(torch, np, "cpu", 4, chunk)
    assert torch.equal(long_batch[1], qrow[:4])
    assert torch.equal(long_batch[3], plen[qrow[:4]])
    assert torch.equal(long_batch[4], plen[qrow[:4] + 512])
    for x, y in zip(big[5:], long_batch[5:]):
        assert torch.equal(x[:4], y)


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
def test_smoke_plain_on_distinct_pairs_is_the_batch_plain(hw_mode):
    """Needs no card: ``chip_smoke.py`` holds K5 on its timed chunk (16,384
    entries, a few dozen distinct pairs) to the plain version run once per
    distinct pair and spread back; that equals the plain version of the
    whole batch on every entry."""
    import chip_smoke

    q, t, ql, tl = _wavefront_code_pairs(9, 6, 96)    # 12 pairs
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), 96, "cpu")
    qrow = torch.tensor([3, 0, 3, 11, 1, 0, 3, 2, 4, 11, 7, 0])
    trow = qrow + 12
    trow[1] = 20                        # one query row with two targets
    got = chip_smoke.plain_on_distinct_pairs(torch, tw, pool, plen, qrow,
                                             trow, Wp=128, hw_mode=hw_mode)
    want = tw.banded_ed_plain(pool[qrow], pool[trow], plen[qrow],
                              plen[trow], Wp=128, hw_mode=hw_mode, small=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
@pytest.mark.parametrize("Wp", [128, 256, 512, 1024, 2048, 32768, 65536])
def test_wavefront_kernel_matches_plain(Wp, hw_mode):
    """K5 against its plain version on every entry, certified or not: the
    register kernel at every band it takes (128 .. 1024), the wide kernel
    above it in shared memory (2048; 32768: the 128 KB opt-in) and the
    device-memory scratch beyond."""
    dev = _card()
    Lp, B = (512, 128) if Wp <= 2048 else (128, 24)
    q, t, ql, tl = _wavefront_code_pairs(4, B, Lp)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), Lp, dev)
    ia = torch.arange(2 * B, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["wavefront_ed"]
    ed, ej = tw.banded_ed_pool(pool, plen, ia, ia + 2 * B, Wp=Wp,
                               hw_mode=hw_mode)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wavefront_ed"] == before + 1
    n, m = plen[ia.long()], plen[(ia + 2 * B).long()]
    wed, wej = tw.banded_ed_plain(pool[ia.long()], pool[(ia + 2 * B).long()],
                                  n, m, Wp=Wp, hw_mode=hw_mode,
                                  small=Wp <= tw.SMALL_WP)
    assert torch.equal(ed, wed) and torch.equal(ej, wej)
    if Wp == 128:
        cert = tw.band_certifies(ed.cpu().numpy(), ql, tl, Wp,
                                 hw_mode=hw_mode, small=True)
        assert (~cert).any() and cert.any()
        assert bool((ed >= tw.CLAMP8).any())


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
@pytest.mark.parametrize("Wp", [128, 256, 512, 1024])
def test_wavefront_register_kernel_ragged_batch(Wp, hw_mode):
    """The register kernel on a batch that is no multiple of the four pairs
    a block, whose warps meet pairs of very different lengths (0, 1, 40,
    L) in turn and length differences outside the band on both sides."""
    dev = _card()
    L, B = 3000, 4 * 37 + 3
    rs = np.random.default_rng(Wp + hw_mode)
    q = np.full((B, L), 6, np.int8)
    t = np.full((B, L), 6, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    H = Wp // 2
    for b in range(B):
        n = (0, 1, 40, L, int(rs.integers(2, L)))[b % 5]
        a = rs.choice(_ALPHA, size=n)
        kind = b % 4
        if kind == 0:                   # a noisy copy
            o = np.where(rs.random(n) < 0.03, rs.choice(_ALPHA, size=n), a)
        elif kind == 1:                 # length difference above the band
            o = np.concatenate([a, rs.choice(_ALPHA, size=H + 1 + b % 7)])
        elif kind == 2:                 # below it
            o = a[:max(0, n - H - b % 5)]
        else:                           # unrelated, any length
            o = rs.choice(_ALPHA, size=int(rs.integers(0, L + 1)))
        o = o[:L]
        q[b, :n] = a
        t[b, :o.size] = o
        ql[b], tl[b] = n, o.size
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), L, dev)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["wavefront_ed"]
    ed, ej = tw.banded_ed_pool(pool, plen, ia, ia + B, Wp=Wp,
                               hw_mode=hw_mode)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wavefront_ed"] == before + 1
    wed, wej = tw.banded_ed_plain(pool[:B], pool[B:], plen[:B], plen[B:],
                                  Wp=Wp, hw_mode=hw_mode,
                                  small=Wp <= tw.SMALL_WP)
    assert torch.equal(ed, wed) and torch.equal(ej, wej)
    delta = tl.astype(np.int64) - ql
    assert (delta > H).any() and (delta < 1 - H).any()


def test_wavefront_scratch_blocks_loop_over_pairs(monkeypatch):
    """More pairs than scratch rows: each block takes several pairs."""
    dev = _card()
    monkeypatch.setattr(tw, "SCRATCH_BLOCKS", 5)
    q, t, ql, tl = _wavefront_code_pairs(6, 16, 128)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), 128, dev)
    ia = torch.arange(32, dtype=torch.int32, device=dev)
    for hw_mode in (False, True):
        got = tw.banded_ed_pool(pool, plen, ia, ia + 32, Wp=65536,
                                hw_mode=hw_mode)
        want = tw.banded_ed_plain(pool[:32], pool[32:], plen[:32], plen[32:],
                                  Wp=65536, hw_mode=hw_mode)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wavefront_engine_on_card_matches_cpu(monkeypatch):
    """The engine's long-bucket route (the constant shrunk) on the card
    against the CPU, NW and HW, with and without caps."""
    _card()
    from isocon_tpu_torch.ops import engine as te

    monkeypatch.setattr(te, "MYERS_MAX_L", 256)
    rng = random.Random(8)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randrange(300, 500)))
            for _ in range(6)]
    seqs += [s[:200] + s[230:] for s in seqs[:3]]
    pairs = [(a, b) for a in seqs for b in seqs]
    cpu = PairEngine(device="cpu")
    gpu = PairEngine(device="cuda")
    for k_cap in (None, np.full(len(pairs), 60)):
        for hw_mode in (False, True):
            got = gpu.edit_distances(pairs, k_cap, hw_mode=hw_mode)
            want = cpu.edit_distances(pairs, k_cap, hw_mode=hw_mode)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1][want[0] >= 0],
                                          want[1][want[0] >= 0])
    assert gpu.counters["ed_pairs_wavefront"] > 0
    assert gpu.wavefront_rungs == cpu.wavefront_rungs


def test_wavefront_saturated_value_certifies():
    """A property of the reference that the port keeps: bands above 192
    lanes saturate at 16,000 and ``band_certifies`` has no test for it, so
    a true distance above 16,000 comes back as 16,000 once the band is
    wide enough (here Wp = 16,384)."""
    _card()
    gpu = PairEngine(device="cuda")
    ed, ej = gpu.edit_distances([("A" * 20000, "C" * 20000)])
    assert (int(ed[0]), int(ej[0])) == (tw.INF, 20000)
    assert max(Wp for _mode, Wp in gpu.wavefront_rungs) == 16384


def test_engine_on_card_matches_cpu():
    _card()
    rng = random.Random(3)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randrange(200, 900)))
            for _ in range(12)]
    pairs = [(a, b) for a in seqs for b in seqs] + [("", "ACGT")]
    cpu = PairEngine(device="cpu")
    gpu = PairEngine(device="cuda")
    for k_cap in (None, np.full(len(pairs), 50)):
        np.testing.assert_array_equal(gpu.edit_distances(pairs, k_cap)[0],
                                      cpu.edit_distances(pairs, k_cap)[0])
        infix = [(a[40:160], b) for a, b in pairs]
        got = gpu.edit_distances(infix, k_cap, hw_mode=True)
        want = cpu.edit_distances(infix, k_cap, hw_mode=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1][want[0] >= 0],
                                      want[1][want[0] >= 0])
    sub = pairs[::7]
    scores = [(2, -2, 2, 0)] * len(sub)
    assert gpu.align_pairs(sub, scores) == cpu.align_pairs(sub, scores)


def test_make_mesh_takes_the_first_cards():
    _card()
    from isocon_tpu_torch.parallel import make_mesh

    every = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    assert make_mesh(1) == every[:1]
    assert make_mesh(-1) == make_mesh() == every
    assert make_mesh(len(every) + 3) == every      # fewer when fewer


@pytest.mark.parametrize("mesh", ["cuda_x2", "cuda_x3", "cuda_and_cpu"])
def test_sharder_matches_local_wrappers(mesh):
    """The wrappers launched and collected through a Sharder (the engine's
    route) of 2 or 3 shards of the card, or of the card and the CPU (whose
    block runs the plain versions on a replica of the pool), equal the
    unsharded wrappers on a ragged batch of 151 pairs: K1 (windows 7
    and 33), K2, K5 (bands 128 and 256, NW and HW) and K3 + K4 (band 256,
    pairs that overflow included; K4's aligned rows, up to each row's
    length, and counts), every entry."""
    from isocon_tpu_torch.parallel import Sharder

    dev = _card()
    cuda0, cpu = torch.device("cuda", 0), torch.device("cpu")
    sh = Sharder({"cuda_x2": [cuda0] * 2, "cuda_x3": [cuda0] * 3,
                  "cuda_and_cpu": [cuda0, cpu]}[mesh])
    B, L = 151, 1056
    q, t, ql, tl = _code_pairs(11, B, L)
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([ql, tl]), L, dev)
    peq = tm.peq_table(pool, plen)
    ia = np.arange(B, dtype=np.int32)
    ib = ia + B
    ia_t, ib_t = (torch.from_numpy(x).to(dev) for x in (ia, ib))

    def sharded(fn, tensors, vectors, **kw):
        return sh.collect(sh.launch(fn, tensors, vectors, **kw))

    for win in (7, 33):
        got, = sharded(tm.myers_ed_pool, (pool, plen, peq), (ia, ib), L=L,
                       win=win)
        np.testing.assert_array_equal(
            got, tm.myers_ed_pool(pool, plen, peq, ia_t, ib_t, L=L,
                                  win=win).cpu().numpy())
    for got, want in zip(
            sharded(tm.myers_hw_pool, (pool, plen, peq), (ia, ib), L=L,
                    win=7),
            tm.myers_hw_pool(pool, plen, peq, ia_t, ib_t, L=L, win=7)):
        np.testing.assert_array_equal(got, want.cpu().numpy())
    for Wp in (128, 256):
        for hw_mode in (False, True):
            for got, want in zip(
                    sharded(tw.banded_ed_pool, (pool, plen), (ia, ib),
                            Wp=Wp, hw_mode=hw_mode),
                    tw.banded_ed_pool(pool, plen, ia_t, ib_t, Wp=Wp,
                                      hw_mode=hw_mode)):
                np.testing.assert_array_equal(got, want.cpu().numpy())
    scores = [np.full(B, 2, np.int32),
              np.array([(-1, -2, -4)[i % 3] for i in range(B)], np.int32),
              np.full(B, 2, np.int32), (np.arange(B) % 2).astype(np.int32)]
    got = sharded(tac.sg_align_pool, (pool, plen), (ia, ib, *scores),
                  to_host=tac.fetch, Wp=256)
    want = tac.fetch(tac.sg_align_pool(
        pool, plen, ia_t, ib_t, *(torch.from_numpy(x).to(dev)
                                  for x in scores), Wp=256))
    assert got[5].any() and not got[5].all()      # some pairs overflow
    assert len(got) == len(want) == 11
    keep = np.arange(want[9].shape[1])[None, :] < want[6][:, None]
    for g, w in zip(got[:9], want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[9:], want[9:]):     # the rows, up to their length
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.where(keep, g, 0),
                                      np.where(keep, w, 0))


def test_engine_pool_replicas_follow_its_growth():
    """An engine on the card and the CPU (whose block reads a replica of
    the card's pool) equals an engine on the card alone while its pool
    takes new rows and grows past its first 1,024 rows; the engine on the
    card alone uses its pools in place (its Sharder names ``cuda:0``)."""
    from isocon_tpu_torch.parallel import Sharder

    dev = _card()
    rng = random.Random(5)
    local = PairEngine(device=dev)
    assert local.sharder.devices == [torch.device("cuda", 0)]
    mixed = PairEngine(device=dev, sharder=Sharder(
        [torch.device("cuda", 0), torch.device("cpu")]))
    scores = (2, -2, 2, 0)
    for n in (100, 200, 900):
        pairs = []
        for _ in range(n):
            a = "".join(rng.choice("ACGT")
                        for _ in range(rng.randrange(80, 200)))
            b = list(a)
            for _ in range(rng.randrange(0, 10)):
                b[rng.randrange(len(b))] = rng.choice("ACGT")
            pairs.append((a, "".join(b)))
        for got, want in zip(mixed.edit_distances(pairs),
                             local.edit_distances(pairs)):
            np.testing.assert_array_equal(got, want)
        assert (mixed.align_pairs(pairs[:40], [scores] * 40)
                == local.align_pairs(pairs[:40], [scores] * 40))
    assert local.sharder._replicas == {}
    # one copy each of the live pool's mat, lens and Peq planes (the
    # alignments share the first two); the grown-out storage's are gone
    kept = list(mixed.sharder._replicas.values())
    assert len(kept) == 3
    assert all(copy.device.type == "cpu" for _ref, copy, _rows in kept)
    assert min(rows for _ref, _copy, rows in kept) > 1024


def _sketch_inputs(N, D=512, seed=0):
    """Square-rooted Poisson counts (float32 [N, D]) with every fifth row
    a copy of an earlier one (exact ties) and a zero row, and lengths."""
    rs = np.random.default_rng(seed)
    prof = rs.poisson(3, size=(N, D)).astype(np.float32)
    for r in range(5, N, 5):
        prof[r] = prof[r // 2]
    if N > 3:
        prof[3] = 0
    lens = rs.integers(700, 1900, N).astype(np.int32)
    return torch.sqrt(torch.from_numpy(prof)), torch.from_numpy(lens)


@pytest.mark.parametrize("N", [1, 2, 63, 4097, 10001])
def test_sketch_kernel_matches_plain(N):
    """K6 bit for bit against the plain version: the whole matrix up to
    4,097 rows, and at 10,001 the first rows, the rows across the 4,096
    chunk seam and the ragged last rows."""
    dev = _card()
    p, lens = (x.to(dev) for x in _sketch_inputs(N))
    spans = ([(0, N)] if N <= 4097 else
             [(0, 130), (tsk.ROW_CHUNK - 70, 140), (N - 97, 97)])
    for row0, rows in spans:
        before = _build.LAUNCHES["sketch_scores"]
        got = tsk.sketch_scores(p, lens, row0, rows)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["sketch_scores"] == before + 1
        want = tsk.sketch_scores_plain(p, lens, row0, rows)
        assert got.shape == (rows, N)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("D", [32, 96])
def test_sketch_kernel_other_depths(D):
    dev = _card()
    p, lens = (x.to(dev) for x in _sketch_inputs(200, D=D, seed=D))
    got = tsk.sketch_scores(p, lens, 37, 100)
    want = tsk.sketch_scores_plain(p, lens, 37, 100)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_sketch_topn_chunk_seams():
    """topn_indices on the card equals the plain top-n of the whole matrix
    whatever chunk it is given (the chunk is the CPU path's; on the card
    the fused top-n takes all rows at once)."""
    dev = _card()
    p, lens = (x.to(dev) for x in _sketch_inputs(4500))
    want = tsk.topn(tsk.sketch_scores_plain(p, lens, 0, 4500), 20)[1]
    for chunk in (100, tsk.ROW_CHUNK):
        assert torch.equal(tsk.topn_indices(p, lens, 20, chunk=chunk), want)


def test_sketch_kernel_rejects_bad_inputs():
    dev = _card()
    p, lens = (x.to(dev) for x in _sketch_inputs(64, D=48))
    with pytest.raises(ValueError, match="multiple of 32"):
        tsk.sketch_scores(p, lens, 0, 64)
    p, lens = (x.to(dev) for x in _sketch_inputs(64))
    with pytest.raises(ValueError, match="outside"):
        tsk.sketch_scores(p, lens, 10, 60)


@pytest.mark.parametrize("D", [32, 64, 512])
@pytest.mark.parametrize("N", [2, 3, 21, 63, 129, 4097, 10001])
def test_sketch_topn_and_merge_match_plain(N, D):
    """The fused top-n's first pass and its merge, each against its plain
    version on the same inputs, bit for bit, for k = 1 and 20 (at most
    N - 1) and one segment, the plan's count and one a tile (at most 32);
    each launch adds one to its counter, and the composition equals topn
    of the plain scores, as topn_scores does in one launch of each."""
    dev = _card()
    p, lens = (x.to(dev) for x in _sketch_inputs(N, D=D, seed=N + D))
    scores = tsk.sketch_scores_plain(p, lens, 0, N)
    tiles = -(-N // tsk.TILE)
    plan = tsk.plan_segments(
        N, torch.cuda.get_device_properties(dev).multi_processor_count)
    for k in sorted({min(1, N - 1), min(20, N - 1)}):
        want_v, want_i = tsk.topn(scores, k)
        for nseg in sorted({1, plan, min(tiles, tsk.MAX_SEGMENTS)}):
            before = dict(_build.LAUNCHES)
            pv, pi = tsk.sketch_topn(p, lens, k, nseg)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["sketch_topn"] == before["sketch_topn"] + 1
            wv, wi = tsk.segment_topn_plain(scores, k,
                                            tsk.segment_bounds(N, nseg))
            assert pv.shape == pi.shape == (N, nseg, k)
            assert torch.equal(pv.view(torch.int32), wv.view(torch.int32))
            assert torch.equal(pi, wi)
            mv, mi = tsk.merge_topn(pv, pi, k)
            torch.cuda.synchronize()
            assert (_build.LAUNCHES["sketch_merge"]
                    == before["sketch_merge"] + 1)
            wmv, wmi = tsk.merge_topn_plain(pv, pi, k)
            assert torch.equal(mv.view(torch.int32), wmv.view(torch.int32))
            assert mi.dtype == torch.int64 and torch.equal(mi, wmi)
            assert torch.equal(mv.view(torch.int32),
                               want_v.view(torch.int32))
            assert torch.equal(mi, want_i)
        before = dict(_build.LAUNCHES)
        v, i = tsk.topn_scores(p, lens, k)
        assert {n: _build.LAUNCHES[n] - before[n] for n in before
                if _build.LAUNCHES[n] != before[n]} == {
                    "sketch_topn": 1, "sketch_merge": 1}
        assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))
        assert torch.equal(i, want_i)


def test_sketch_topn_rejects_bad_inputs():
    dev = _card()
    p, lens = (x.to(dev) for x in _sketch_inputs(300))
    for k, nseg, match in ((0, 1, "k 0"), (33, 1, "k 33"), (20, 4,
                                                             "segments 4"),
                           (20, 0, "segments 0")):
        with pytest.raises(ValueError, match=match):
            tsk.sketch_topn(p, lens, k, nseg)
    q, lq = (x.to(dev) for x in _sketch_inputs(300, D=48))
    with pytest.raises(ValueError, match="multiple of 32"):
        tsk.sketch_topn(q, lq, 20, 1)
    with pytest.raises(ValueError, match="lens"):
        tsk.sketch_topn(p, lens[:-1], 20, 1)
    with pytest.raises(ValueError, match="k 3"):
        tsk.sketch_topn(p[:3], lens[:3], 3, 1)
    vals = torch.zeros((5, 33, 4), dtype=torch.float32, device=dev)
    idx = torch.zeros((5, 33, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="S 33"):
        tsk.merge_topn(vals, idx, 4)
    with pytest.raises(ValueError, match="k = 3"):
        tsk.merge_topn(vals[:, :2], idx[:, :2], 3)
    with pytest.raises(TypeError):
        tsk.merge_topn(vals[:, :2].double(), idx[:, :2], 4)


def _profile_reads(N, seed):
    """N seeded reads' bytes back to back and their offsets: lengths of
    719-1,985, every 97th 0-9, every 401st from 5 longer than one of K7's
    stages (2,048 starts) up to 16,569 and read 2 exactly 16,569; upper-
    and lowercase, N and IUPAC letters."""
    rs = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTACGTACGTacgtNnRYKMswbdhv", dtype=np.uint8)
    lens = rs.integers(719, 1986, N)
    lens[::97] = rs.integers(0, 10, lens[::97].size)
    lens[5::401] = rs.integers(2049, 16570, lens[5::401].size)
    if N > 2:
        lens[2] = 16569
    raw = alpha[rs.integers(0, alpha.size, int(lens.sum()))]
    off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    return torch.from_numpy(raw), torch.from_numpy(off)


@pytest.mark.parametrize("N", [1, 2, 63, 2001, 10001])
def test_kmer_profile_kernel_matches_plain(N):
    """K7 bit for bit against its plain version on every entry, in one
    launch; and on offsets into the middle of the buffer."""
    dev = _card()
    raw, off = _profile_reads(N, seed=N)
    want = tsk.kmer_profiles_plain(raw, off)
    raw_d, off_d = raw.to(dev), off.to(dev)
    before = _build.LAUNCHES["kmer_profile"]
    got = tsk.kmer_profiles(raw_d, off_d)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["kmer_profile"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (N, tsk.DIM)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    lo, hi = N // 3, N - N // 4
    got = tsk.kmer_profiles(raw_d, off_d[lo:hi + 1])
    assert torch.equal(got.cpu().view(torch.int32),
                       want[lo:hi].view(torch.int32))


def test_kmer_profile_rejects_bad_inputs():
    dev = _card()
    raw, off = (x.to(dev) for x in _profile_reads(5, seed=3))
    with pytest.raises(TypeError, match="uint8"):
        tsk.kmer_profiles(raw.to(torch.int8), off)
    with pytest.raises(TypeError, match="int64"):
        tsk.kmer_profiles(raw, off.to(torch.int32))
    with pytest.raises(ValueError, match="mixed devices"):
        tsk.kmer_profiles(raw, off.cpu())


def test_approximate_matches_on_card_equal_per_read_roots(tmp_path):
    """A seeded 2,000-read set: the lists from K7's roots equal those from
    the per-read ``kmer_profile`` rows (the lists before K7), one launch of
    K7, K6's first pass and its merge; the engine counters take the rows
    K7 built and the bytes sent."""
    from isocon_tpu_torch.graph import sketch as gsk
    from isocon_tpu_torch.io import read_fasta
    from isocon_tpu_torch.workload import write_reads

    dev = _card()
    path = str(tmp_path / "reads.fa")
    write_reads(path, 2000, families=4)
    seqs = sorted({s for _a, s in read_fasta(path)})
    roots = torch.from_numpy(np.sqrt(np.stack(
        [gsk.kmer_profile(s) for s in seqs]))).to(dev)
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32,
                        device=dev)
    want = tsk.topn_indices(roots, lens, gsk.TOPN).cpu().tolist()
    counters = {"sketch_profile_seconds": 0.0, "upload_bytes": 0,
                "sketch_profile_card_rows": 0}
    before = dict(_build.LAUNCHES)
    got = gsk.approximate_matches(seqs, device="cuda", counters=counters)
    assert {n: _build.LAUNCHES[n] - before[n] for n in before
            if _build.LAUNCHES[n] != before[n]} == {
                "kmer_profile": 1, "sketch_topn": 1, "sketch_merge": 1}
    assert got == want
    assert counters["sketch_profile_card_rows"] == len(seqs)
    assert counters["upload_bytes"] == (sum(len(s) for s in seqs)
                                        + 8 * (len(seqs) + 1))


def test_engine_on_card_launches_before_collecting(monkeypatch):
    """A card engine never takes the host route, even with
    ``ISOCON_NO_NATIVE`` unset.  Its launch-first loops give the same
    distances and alignments, with the same kernel launches, as an engine
    that collects each batch at its launch.  A launch queues its uploads
    without waiting for the stream, and the host vectors may be rewritten
    as soon as it returns."""
    from isocon_tpu_torch.parallel import Sharder

    class Eager(Sharder):
        def launch(self, fn, tensors, vectors, **kw):
            return super().collect(super().launch(fn, tensors, vectors,
                                                  **kw))

        def collect(self, result):
            return result

    dev = _card()
    monkeypatch.delenv("ISOCON_NO_NATIVE", raising=False)
    rng = random.Random(12)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randrange(200, 1500)))
            for _ in range(40)]
    pairs = [(a, b) for a in seqs for b in seqs]
    scores = [(2, -2, 2, 1)] * len(pairs)
    gpu = PairEngine(device="cuda")
    assert not gpu.native_cpu
    got = []
    for eng in (gpu, PairEngine(device="cuda", sharder=Eager([dev]))):
        before = dict(_build.LAUNCHES)
        got.append((eng.edit_distances(pairs, np.full(len(pairs), 300)),
                    eng.edit_distances(pairs, hw_mode=True),
                    eng.align_pairs(pairs[::5], scores[::5]),
                    {k: _build.LAUNCHES[k] - before[k] for k in before}))
    for a, b in zip(got[0][:2], got[1][:2]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1][a[0] >= 0], b[1][a[0] >= 0])
    assert got[0][2] == got[1][2] and got[0][3] == got[1][3]
    pool = torch.zeros((4, 256), dtype=torch.uint8, device=dev)
    plen = torch.ones(4, dtype=torch.int32, device=dev)
    ia = np.arange(5, dtype=np.int32)
    ib = ia.copy()
    torch.cuda._sleep(500_000_000)      # the uploads queue behind it
    batch = gpu.sharder.launch(lambda p, l, a, b: (a + b,), (pool, plen),
                               (ia, ib))
    assert not torch.cuda.current_stream(dev).query()
    ia[:] = 99
    ib[:] = 99
    np.testing.assert_array_equal(gpu.sharder.collect(batch)[0],
                                  2 * np.arange(5))


def _consensus_round(name):
    """A packed MAM round (``correct/dense.py::pack_round``): the smoke's
    targeted and long rounds; ``wide``, a row that mismatches at every one
    of 33,000 columns (two freqs: its '-' bytes are of the deletion type,
    its letters of the substitution type) and one at every second column;
    ``mixed``, seeded stars of many sizes, noise up to 12% (ambiguous
    columns), converged members and insertion hotspots."""
    import chip_smoke
    from isocon_tpu_torch.correct.dense import build_dense_mam, pack_round

    if name in chip_smoke.CONSENSUS_SHAPES:
        return chip_smoke.consensus_round_inputs(np, name)
    rs = np.random.default_rng(9)
    if name == "wide":
        W, K = 33000, 8
        acgt = np.frombuffer(b"ACGT", np.uint8)
        codes = rs.integers(0, 4, W)
        mat = np.tile(acgt[codes], (K, 1))
        other = np.frombuffer(b"ACGT-", np.uint8)[
            (codes + rs.integers(1, 5, W)) % 5]
        mat[6] = other
        half = rs.random(W) < 0.5
        mat[7, half] = other[half]
        return (mat.ravel(), np.array([[0, K, W, 0, 0]], np.int64),
                np.ones(K, np.int64),
                np.stack([np.arange(K), np.zeros(K, np.int64)]))
    parts = []
    for L, K, noise in ((60, 3, 0.1), (300, 12, 0.12), (900, 40, 0.02),
                        (2000, 25, 0.01), (150, 6, 0.05), (5000, 9, 0.004)):
        m, part = chip_smoke.star_partition(np, rs, L, K, noise,
                                            degrees=(1, 1, 2, 3),
                                            hotspots=L // 40)
        parts.append(build_dense_mam(m, part))
    return pack_round(parts)


@pytest.mark.parametrize("name", ["targeted", "long", "wide", "mixed"])
def test_consensus_kernels_match_plain(name):
    """The consensus chain (vote, then correction) equals its plain
    version on every output, the rows up to their length."""
    import chip_smoke
    from isocon_tpu_torch.ops import consensus as cons

    dev = _card()
    flat, table, deg, rows = (torch.from_numpy(a)
                              for a in _consensus_round(name))
    kw = dict(cols=int(table[:, 2].sum()), width=int(table[:, 2].max()))
    got = cons.consensus_cuda(*(a.to(dev) for a in (flat, table, deg, rows)),
                              **kw)
    want = cons.consensus_plain(flat, table, deg, rows, **kw)
    chip_smoke.check_consensus(torch, name, got, want)
    if name == "wide":
        assert int(want[6][6]) == kw["width"]
    if name == "mixed":
        assert (want[2] == 0).any() and (deg > 1).any()


def test_correct_strings_on_the_card_launches_the_chain():
    """MAM correction with a card engine: one vote and one correction
    launch a round, and the CPU's corrections."""
    import chip_smoke
    from isocon_tpu_torch.correct.consensus import correct_strings

    _card()
    rs = np.random.default_rng(4)
    pa, s2a = {}, {}
    for L, K, noise, degrees in ((1300, 81, 0.01, (1, 1, 2)),
                                 (400, 2, 0.02, (1,)), (300, 1, 0.0, (1,)),
                                 (16569, 20, 0.002, (1,))):
        m, part = chip_smoke.star_partition(np, rs, L, K, noise,
                                            degrees=degrees, hotspots=3)
        pa[m] = part
    for s in (s for part in pa.values() for s in part):
        s2a[s] = ["r%d" % len(s2a)]
    engine = PairEngine(device="cuda")
    _build.reset_launches()
    got = correct_strings(pa, s2a, 1, engine=engine)
    assert _build.LAUNCHES["consensus_vote"] == 1
    assert _build.LAUNCHES["consensus_correct"] == 1
    assert got == correct_strings(pa, s2a, 1)
    assert got[0]
    assert engine.counters["consensus_rows_card"] == sum(
        len(p) for p in pa.values()
        if len(p) > 1 and sum(t[3] for t in p.values()) > 2)
    assert engine.counters["consensus_rows_host"] == 2
