"""The loop of K1 / K2's band kernel (``csrc/myers_ed.cu``) on the CPU.

``band_pair`` below runs one pair as one lane (thread) of the kernel does,
in uint32 arithmetic on Python ints: the phases (head phases W0 = 0,
steady phases W0 = p - HALF, tail phases W0 = nwords - WIN, a last partial
phase, and the stop past phase nword + HALF once row n's word has left the
window; K2 stops at column m, or sweeps nothing where m < jlow fixes its
answer), the window's Peq words staged in six slots (slot = code for codes
0-3 and N, slot 4 zero for X and codes above 5) and moved with the window,
one new word a plane, the phase's 32 text codes staged once a phase, the
word step with the funnel-shift carries, and the answer read from the
banded table: T, the value of the row above the window (hin a column, plus
the dropped word's vertical sum when the window moves), and V, the vertical
sum from the window top to row n, give D'[n][j] = T + V.  ``band_warp``
runs the lanes of one warp in lockstep, phase by phase: K1 runs one body in
every phase; K2's lanes still in their sweep vote, and all of them run the
walk body (row n's bits under per-phase word masks) if one of them has row
n's word in the window, K1's body otherwise.  On seeded pairs, in warps of
32 consecutive pairs as the kernel launches them, it must give
``myers_ed_plain`` / ``myers_hw_plain``'s results and the JAX kernel's in
interpret mode on every entry.  Tolerance: exact (integer DP).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from isocon_tpu.ops.myers_pallas import myers_ed_pallas, myers_hw_pallas
from isocon_tpu_torch.ops import myers as tm

MASK = 0xFFFFFFFF
ZERO_SLOT = 4
L = 384
WARP = 32
_ALPHA = np.array([0, 1, 2, 3, 5, 4], np.uint8)     # ACGT, N, X


def _fshl(lo, hi):
    """__funnelshift_l(lo, hi, 1)."""
    return ((hi << 1) | (lo >> 31)) & MASK


def _pop(x):
    return x.bit_count()


def rows_to_n(pv, mv, rsel, nbit):
    """V: the vertical sum from the window top to row n (bit nbit of word
    rsel)."""
    last = (2 << nbit) - 1
    v = 0
    for k in range(len(pv)):
        keep = MASK if k < rsel else (last if k == rsel else 0)
        v += _pop(pv[k] & keep) - _pop(mv[k] & keep)
    return v


def band_pair(peq_row, text, n, m, *, L, win, hw, plan=None):
    """One pair as one lane of the band kernel, a generator.  peq_row:
    [5][NWp] Peq words of the query; text: the target's pool row (codes,
    >= m).  At each phase it yields its vote (K2: row n's word is in the
    window; K1 does not vote) and is sent the warp's body (True: the walk
    body); it returns ed (NW) or (ed, ej) (HW) and appends (p, W0, body,
    row n's word in the window, the walk's state changed) of each phase to
    ``plan``."""
    half = win // 2
    nwp = len(peq_row[0])
    nwords = L // 32
    nword = (n - 1) >> 5
    nbit = (n - 1) & 31
    jlow = max(n - 32 * half, 1)
    pv = [MASK] * win
    mv = [0] * win
    top = anchor = walk = wj = 0
    wmin = 1 << 29
    entered = False
    last = (0 if m < jlow else m) if hw else m
    pend = 0 if nword < 0 else min((last + 31) >> 5, nword + half + 1
                                   if nwords - win > nword else nwords)
    def word(c, w):
        return peq_row[c][w] if w < nwp else 0

    slots = [[0] * win for _ in range(6)]       # slot 4 stays zero
    for c in range(5):
        slots[c if c < 4 else 5] = [word(c, k) for k in range(win)]
    W0 = 0
    for p in range(pend):
        W0 = min(max(p - half, 0), nwords - win)
        if half + 1 <= p <= nwords - win + half:    # W0 moved a word
            top += _pop(pv[0]) - _pop(mv[0])
            pv = pv[1:] + [MASK]
            mv = mv[1:] + [0]
            for c in range(5):
                sl = c if c < 4 else 5
                slots[sl] = slots[sl][1:] + [word(c, W0 + win - 1)]
        codes = [int(x) for x in text[32 * p:32 * p + 32]]
        ncol = min(32, last - 32 * p)
        zero_top = hw and W0 == 0
        hin31 = 0 if zero_top else 1 << 31
        rsel = nword - W0
        assert rsel >= 0
        if hw and rsel < win and not entered:
            anchor = top + rows_to_n(pv, mv, rsel, nbit)
            entered = True
        walking = yield hw and rsel < win
        assert hw or not walking
        rm = [1 << nbit if k == rsel else 0 for k in range(win)]
        state = (walk, wmin, wj)
        for s in range(ncol):
            code = codes[s]
            eq = slots[ZERO_SLOT if code > 5 else code]
            prev_ph, prev_mh = hin31, 0
            hp = hm = 0
            for k in range(win):
                pvk, mvk = pv[k], mv[k]
                xv = eq[k] | mvk
                e = eq[k] if k == 0 else eq[k] | (prev_mh >> 31)
                xh = ((((e & pvk) + pvk) & MASK) ^ pvk) | e
                ph = (mvk | ~(xh | pvk)) & MASK
                mh = pvk & xh
                if walking:
                    hp |= ph & rm[k]
                    hm |= mh & rm[k]
                phs = _fshl(prev_ph, ph)
                mhs = _fshl(prev_mh, mh)
                pv[k] = (mhs | ~(xv | phs)) & MASK
                mv[k] = phs & xv
                prev_ph, prev_mh = ph, mh
            if walking:
                walk += (hp != 0) - (hm != 0)
                j = 32 * p + s + 1
                assert j <= m       # the sweep ends at m
                if j >= jlow and walk < wmin:
                    wmin, wj = walk, j
        if not zero_top:
            top += ncol
        if plan is not None:
            plan.append((p, W0, "walk" if walking else "plain", rsel < win,
                         (walk, wmin, wj) != state))
    if hw:
        v = anchor + wmin
        return min(v, n), 0 if n <= v else wj
    return 0 if pend == 0 else top + rows_to_n(pv, mv, nword - W0, nbit)


def band_warp(lanes, *, L, win, hw, plans=None):
    """The lanes (peq_row, text, n, m) of one warp through ``band_pair`` in
    lockstep: at each phase the lanes still in their sweep vote (a lane
    past its last phase has left the loop and is not asked), and all of
    them run the walk body if one votes for it; K1 never walks.  Returns
    each lane's result; ``plans[i]`` gets lane i's phases."""
    gens = [band_pair(*lane, L=L, win=win, hw=hw,
                      plan=None if plans is None else plans[i])
            for i, lane in enumerate(lanes)]
    results = [None] * len(gens)

    def step(i, walking=None):
        try:
            return gens[i].send(walking)
        except StopIteration as done:
            results[i] = done.value
            return None

    votes = {i: step(i) for i in range(len(gens))}
    votes = {i: v for i, v in votes.items() if v is not None}
    while votes:
        walking = any(votes.values())
        votes = {i: step(i, walking) for i in votes}
        votes = {i: v for i, v in votes.items() if v is not None}
    return results


def _pairs(kind, seed, B=128):
    """Seeded code pairs (q, t, qlen, tlen) of width L; rows are padded with
    6 past their length, except that every fourth row holds codes that
    would match there."""
    rs = np.random.default_rng(seed)
    q = np.full((B, L), 6, np.uint8)
    t = np.full((B, L), 6, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        if kind == "head":          # n, m <= 32 * HALF at win 7
            n, m = int(rs.integers(1, 97)), int(rs.integers(1, 97))
        elif kind == "tail":        # the window clips at nwords - WIN
            n, m = int(rs.integers(300, L + 1)), int(rs.integers(300, L + 1))
        elif kind == "equal":       # n = m, and n = 1 in a few
            n = m = 1 if b % 8 == 0 else int(rs.integers(1, L + 1))
        else:                       # mixed lengths and queries of 1
            n = 1 if b % 10 == 0 else int(rs.integers(1, L + 1))
            m = int(rs.integers(1, L + 1))
        a = rs.choice(_ALPHA, size=n, p=[.22, .22, .22, .22, .08, .04])
        o = np.concatenate([a, rs.choice(_ALPHA, size=max(m - n, 0))])[:m]
        hit = rs.random(m) < rs.uniform(0, 0.35)
        o[hit] = rs.choice(_ALPHA, size=int(hit.sum()))
        if b % 7 == 3:              # an unrelated target
            o = rs.choice(_ALPHA, size=m)
        q[b, :n], t[b, :m] = a, o
        if b % 4 == 1:
            q[b, n:] = rs.integers(0, 4, size=L - n)
            t[b, m:] = rs.integers(0, 4, size=L - m)
        ql[b], tl[b] = n, m
    return q, t, ql, tl


_CASES = {}


def _case(kind, win, hw):
    """(model results, plain results, plans, (q, t, ql, tl), (n, m)) of a
    case, the pairs run in warps of 32 consecutive lanes.  Kind "warps":
    ``chip_smoke.hw_warp_pairs``, one warp of each of its kinds and a last
    warp of 5 lanes."""
    key = (kind, win, hw)
    if key in _CASES:
        return _CASES[key]
    if kind == "warps":
        q, t, ql, tl = chip_smoke.hw_warp_pairs(np, L)
    else:
        q, t, ql, tl = _pairs(kind, {"head": 1, "tail": 2, "equal": 3,
                                     "mixed": 4}[kind])
    B = q.shape[0]
    pool = torch.from_numpy(np.concatenate([q, t]))
    plen = torch.from_numpy(np.concatenate([ql, tl]))
    peq = tm.peq_table(pool, plen)
    ia = torch.arange(B)
    if hw:
        qrow, trow, n, m = ia, ia + B, plen[ia], plen[ia + B]
        plain = tm.myers_hw_plain(peq[qrow], pool[trow], n, m, L=L, win=win)
        plain = np.stack([x.numpy() for x in plain])
    else:
        qrow, trow, n, m = tm._swap(plen, ia, ia + B)
        plain = tm.myers_ed_plain(peq[qrow], pool[trow], n, m, L=L,
                                  win=win).numpy()[None]
    words = peq.numpy().view(np.uint32)
    lanes = [([[int(x) for x in row] for row in words[int(qrow[b])]],
              pool[int(trow[b])].numpy(), int(n[b]), int(m[b]))
             for b in range(B)]
    plans = [[] for _ in range(B)]
    got = []
    for w in range(0, B, WARP):
        res = band_warp(lanes[w:w + WARP], L=L, win=win, hw=hw,
                        plans=plans[w:w + WARP])
        got += [r if hw else (r,) for r in res]
    _CASES[key] = (np.array(got, np.int64).T, plain, plans, (q, t, ql, tl),
                   (n.numpy(), m.numpy()))
    return _CASES[key]


_PARAMS = [(kind, win, hw) for kind in ("head", "tail", "equal", "mixed")
           for win in (7, 9) for hw in (False, True)] + \
    [("warps", win, True) for win in (7, 9)]
_IDS = ["%s-win%d-%s" % (k, w, "hw" if h else "nw") for k, w, h in _PARAMS]
_HW_PARAMS = [(k, w) for k, w, h in _PARAMS if h]


@pytest.mark.parametrize("kind,win,hw", _PARAMS, ids=_IDS)
def test_model_equals_plain(kind, win, hw):
    got, plain, _plans, _, _ = _case(kind, win, hw)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("kind,win,hw", _PARAMS, ids=_IDS)
def test_model_equals_jax_interpret(kind, win, hw):
    got, _plain, _plans, (q, t, ql, tl), _ = _case(kind, win, hw)
    B = q.shape[0]
    # the JAX kernel takes blocks of 128 pairs: pad with the first pair
    fill = np.zeros((-B) % 128, np.int64)
    q, t, ql, tl = (np.concatenate([x, x[fill]]) for x in (q, t, ql, tl))
    fn = myers_hw_pallas if hw else myers_ed_pallas
    want = fn(q.view(np.int8), t.view(np.int8), ql, tl, L=L, interpret=True,
              sub=1, win=win)
    want = np.stack([np.asarray(x)[:B] for x in want]) if hw else \
        np.asarray(want)[None, :B]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,win", _HW_PARAMS)
def test_hw_walk_outside_the_window_adds_nothing(kind, win):
    """K2 runs its walk body in every lane of a warp where one lane walks:
    in a lane whose row n's word is below the window its masks are 0, so
    the walk, its minimum and its end column stay as they were.  Such
    phases occur in warps of mixed queries, and never in a warp of one
    query, whose lanes walk in the same phases."""
    _got, _plain, plans, _, (n, _m) = _case(kind, win, True)
    outside = [changed for plan in plans for _p, _w, body, inside, changed
               in plan if body == "walk" and not inside]
    assert not any(outside)
    if kind != "head":      # n <= 32 * HALF keeps row n in the window
        assert outside
    for w in range(0, len(plans), WARP):
        if len(set(n[w:w + WARP].tolist())) == 1:       # one query
            assert all(inside for plan in plans[w:w + WARP]
                       for _p, _w, body, inside, _c in plan
                       if body == "walk")


@pytest.mark.parametrize("kind,win,hw", _PARAMS, ids=_IDS)
def test_phases_cover_head_steady_tail_and_stop(kind, win, hw):
    """K1 runs one body in every phase; K2 the walk body in a phase where a
    lane of its warp still in its sweep has row n's word in the window,
    K1's body in the others.  The head case never leaves the head phases,
    the tail case reaches the clipped window, the others cross head ->
    steady, a lane stops after phase nword + HALF once the window can move
    below row n, and K2's lane at column m (or sweeps nothing where m <
    jlow); ``chip_smoke.myers_columns`` and ``hw_vote_share`` count the
    same phases."""
    _got, _plain, plans, _, (n, m) = _case(kind, win, hw)
    half, nwords = win // 2, L // 32
    seen = set()
    for b, plan in enumerate(plans):
        nword = (int(n[b]) - 1) >> 5
        jlow = max(int(n[b]) - 32 * half, 1)
        last = int(m[b]) if not hw or int(m[b]) >= jlow else 0
        stop = nword + half + 1 if nwords - win > nword else nwords
        assert len(plan) == max(0, min((last + 31) >> 5, stop)) if \
            nword >= 0 else not plan
        for p, W0, _body, _inside, _changed in plan:
            steady = W0 == p - half
            tail = W0 == nwords - win and W0 < p - half
            seen.add("steady" if steady else "tail" if tail else "head")
    fired = warp_phases = 0
    for w in range(0, len(plans), WARP):
        warp = plans[w:w + WARP]
        for p in range(max(len(plan) for plan in warp)):
            rows = [plan[p] for plan in warp if len(plan) > p]
            walks = hw and any(inside for _p, _w, _b, inside, _c in rows)
            assert {body for _p, _w, body, _i, _c in rows} == {
                "walk" if walks else "plain"}
            fired += walks
            warp_phases += 1
    cols = chip_smoke.myers_columns(torch.from_numpy(n), torch.from_numpy(m),
                                    win, hw, L)
    assert ((cols + 31) // 32).tolist() == [len(plan) for plan in plans]
    if hw:
        assert chip_smoke.hw_vote_share(torch.from_numpy(n),
                                        torch.from_numpy(m), win, L) == (
            fired, warp_phases)
        assert fired > 0
        if kind in ("tail", "warps"):   # warps where no lane walks
            assert warp_phases > fired
    if kind == "head":
        assert seen == {"head"}
    if kind == "tail":
        assert "tail" in seen
    if kind in ("equal", "mixed", "warps"):
        assert {"head", "steady"} <= seen
