"""The port's banded wavefront edit distance (plain version of K5) against
the JAX package: the Pallas kernel in interpret mode at Wp = 128, the
``lax.scan`` ``banded_ed`` at wider bands, ``band_certifies`` and
``_certified_floor`` over a grid, and certified entries against the numpy
oracle.  Inputs are seeded numpy arrays handed to both.  Tolerance: exact
on every entry of ``(ed, end_j)``, certified or not.
"""
import numpy as np
import pytest
import torch

from isocon_tpu.ops import wavefront as jw
from isocon_tpu.ops.engine import PairEngine as JaxEngine
from isocon_tpu.ops.wavefront_pallas import banded_ed_pallas
from isocon_tpu_torch.ops import oracle
from isocon_tpu_torch.ops import wavefront as tw
from isocon_tpu_torch.ops.engine import PairEngine

_ALPHA = np.array([0, 1, 2, 3, 5], np.int8)


def _pairs(seed, B, L, dmax):
    """Seeded code pairs in [B, L] planes: mutated copies (0-30%), unrelated
    pairs, exact and mutated infixes, length differences up to ``dmax`` in
    both directions, and lengths 0 and 1 on either side."""
    rs = np.random.default_rng(seed)
    q = np.full((B, L), 7, np.int8)
    t = np.full((B, L), 7, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        kind = b % 8
        n = int(rs.integers(L // 6, L - 4))
        a = rs.choice(_ALPHA, size=n, p=[.24, .24, .24, .24, .04])
        if kind == 0:                       # unrelated
            o = rs.choice(_ALPHA, size=int(rs.integers(1, L)))
        elif kind == 1:                     # an infix of the target
            pre = rs.choice(_ALPHA, size=int(rs.integers(0, dmax)))
            o = np.concatenate([pre, a, rs.choice(
                _ALPHA, size=int(rs.integers(0, dmax)))])
        elif kind == 2:                     # the target an infix of the query
            lo = int(rs.integers(0, min(dmax, n - 1)))
            o = a[lo:max(lo + 1, n - int(rs.integers(0, dmax)))]
        else:                               # mutated copy, a few divergent
            div = rs.uniform(0, 0.3) if kind == 3 else rs.uniform(0, 0.06)
            keep = rs.random(n) >= div / 2
            o = np.where(rs.random(n) < div / 2,
                         rs.choice(_ALPHA, size=n), a)[keep]
            if kind == 4:
                o = np.concatenate([o, rs.choice(
                    _ALPHA, size=int(rs.integers(0, dmax)))])
        o = o[:L]
        if o.size == 0:
            o = a[:1]
        q[b, :n] = a
        t[b, :o.size] = o
        ql[b], tl[b] = n, o.size
    # lengths 0 and 1 on either side
    for b, (n, m) in zip(range(B - 8, B), [(0, 0), (0, 1), (1, 0), (1, 1),
                                           (0, 40), (40, 0), (1, 90),
                                           (90, 1)]):
        ql[b], tl[b] = n, m
    return q, t, ql, tl


def _plain(q, t, ql, tl, **kw):
    ed, ej = tw.banded_ed_plain(
        torch.from_numpy(q.view(np.uint8)), torch.from_numpy(t.view(np.uint8)),
        torch.from_numpy(ql), torch.from_numpy(tl), **kw)
    return ed.numpy(), ej.numpy()


def _decode(row, k):
    return "".join("ACGTXN"[c] for c in row[:k])


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
def test_plain_matches_pallas_interpret(hw_mode):
    q, t, ql, tl = _pairs(11, 128, 256, 120)
    want_ed, want_ej = banded_ed_pallas(q, t, ql, tl, Wp=128, L=256,
                                        hw_mode=hw_mode, interpret=True)
    ed, ej = _plain(q, t, ql, tl, Wp=128, hw_mode=hw_mode, small=True)
    np.testing.assert_array_equal(ed, np.asarray(want_ed))
    np.testing.assert_array_equal(ej, np.asarray(want_ej))
    cert = tw.band_certifies(ed, ql, tl, 128, hw_mode=hw_mode, small=True)
    delta = tl.astype(np.int64) - ql
    # the set holds what the kernel check on the card must hold
    assert (~cert).any() and cert.any()
    assert (ed >= tw.CLAMP8).any()
    if hw_mode:
        assert (ql > tl).any() and (ej[ql > 1] == 0).any()
        assert (ed == 2 ** 30).any()        # no cell of row n in the band
    else:
        assert (delta > 64).any() and (delta < -63).any()


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
@pytest.mark.parametrize("Wp", [256, 512])
def test_plain_matches_scan_wide(Wp, hw_mode):
    L = 512
    q, t, ql, tl = _pairs(Wp + int(hw_mode), 64, L, 300)
    want_ed, want_ej = jw.banded_ed(q, t, ql, tl, Wp=Wp, L=L,
                                    hw_mode=hw_mode, small=False)
    ed, ej = _plain(q, t, ql, tl, Wp=Wp, hw_mode=hw_mode, small=False)
    np.testing.assert_array_equal(ed, np.asarray(want_ed))
    np.testing.assert_array_equal(ej, np.asarray(want_ej))
    if Wp == 256:
        cert = tw.band_certifies(ed, ql, tl, Wp, hw_mode=hw_mode)
        assert (~cert).any() and cert.any()


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
def test_plain_matches_scan_small(hw_mode):
    """At Wp = 128 the scan's int8 variant gives the same values wherever a
    cell of row n lies in the band (its unset HW answer is 16,000 where the
    Pallas kernel's is 2^30)."""
    q, t, ql, tl = _pairs(5, 64, 256, 120)
    want_ed, want_ej = jw.banded_ed(q, t, ql, tl, Wp=128, L=256,
                                    hw_mode=hw_mode, small=True)
    ed, ej = _plain(q, t, ql, tl, Wp=128, hw_mode=hw_mode, small=True)
    seen = ed < 2 ** 30
    np.testing.assert_array_equal(ed[seen], np.asarray(want_ed)[seen])
    np.testing.assert_array_equal(ej[seen], np.asarray(want_ej)[seen])
    assert (np.asarray(want_ed)[~seen] == jw.INF).all()


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
@pytest.mark.parametrize("Wp", [128, 256])
def test_certified_entries_match_oracle(Wp, hw_mode):
    q, t, ql, tl = _pairs(3, 48, 256, 100)
    small = Wp <= tw.SMALL_WP
    ed, ej = _plain(q, t, ql, tl, Wp=Wp, hw_mode=hw_mode, small=small)
    cert = tw.band_certifies(ed, ql, tl, Wp, hw_mode=hw_mode, small=small)
    assert cert.sum() >= 10
    for b in np.flatnonzero(cert & (ql > 0) & (tl > 0)).tolist():
        a, c = _decode(q[b], ql[b]), _decode(t[b], tl[b])
        if hw_mode:
            d, _s0, e0, _ops = oracle.edit_distance_hw(a, c)
            assert (int(ed[b]), int(ej[b])) == (d, e0 + 1), b
        else:
            assert int(ed[b]) == oracle.edit_distance(a, c), b
            assert int(ej[b]) == tl[b]


def test_pool_entry_runs_plain_on_cpu():
    q, t, ql, tl = _pairs(9, 16, 128, 60)
    pool = torch.from_numpy(np.concatenate([q, t]).view(np.uint8))
    plen = torch.from_numpy(np.concatenate([ql, tl]))
    ia = torch.arange(16)
    for Wp, hw_mode in ((128, False), (128, True), (256, True)):
        got = tw.banded_ed_pool(pool, plen, ia, ia + 16, Wp=Wp,
                                hw_mode=hw_mode)
        want = _plain(q, t, ql, tl, Wp=Wp, hw_mode=hw_mode,
                      small=Wp <= tw.SMALL_WP)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_plain_rejects_bad_geometry():
    z = torch.zeros((1, 8), dtype=torch.uint8)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tw.banded_ed_plain(z, z, one, one, Wp=130)
    with pytest.raises(ValueError):
        tw.banded_ed_plain(z, z, one * 9, one, Wp=128)


@pytest.mark.parametrize("small", [False, True], ids=["wide", "small"])
@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
@pytest.mark.parametrize("Wp", [128, 256, 1024, 4096])
def test_band_certifies_and_floor_match(Wp, hw_mode, small):
    rs = np.random.default_rng(Wp)
    n = rs.integers(0, 6000, 4000).astype(np.int32)
    m = (n + rs.integers(-Wp, Wp + 1, 4000)).clip(0).astype(np.int32)
    ed = rs.integers(0, 2 * Wp, 4000).astype(np.int32)
    ed[::7] = rs.choice([119, 120, 121, 16000, 2 ** 30], 4000)[::7]
    got = tw.band_certifies(ed, n, m, Wp, hw_mode=hw_mode, small=small)
    want = jw.band_certifies(ed, n, m, Wp, hw_mode=hw_mode, small=small)
    np.testing.assert_array_equal(got, want)
    floor = PairEngine._certified_floor(n, m, Wp, hw_mode)
    want_floor = np.asarray([
        JaxEngine._certified_floor(int(a), int(b), Wp, hw_mode)
        for a, b in zip(n, m)])
    np.testing.assert_array_equal(floor, want_floor)
    # the floor's claim: any distance up to it would have certified by the
    # rule the engine applies at this width.  It fails, in the JAX engine
    # and here alike, exactly where a small band's floor reaches its
    # ceiling (NW at Wp = 128 with -6 <= m - n <= 8: floors 120 .. 127)
    at = floor >= 0
    small_band = Wp <= tw.SMALL_WP
    cert = tw.band_certifies(floor[at], n[at], m[at], Wp, hw_mode=hw_mode,
                             small=small_band)
    np.testing.assert_array_equal(
        cert, ~(small_band & (floor[at] >= tw.CLAMP8)))
    if small_band and not hw_mode:
        assert (~cert).any()
        delta = (m[at].astype(np.int64) - n[at])[~cert]
        assert ((delta >= -6) & (delta <= 8)).all()


def test_constants_match():
    assert (tw.CLAMP8, int(tw.INF), tw.QPAD, tw.TPAD) == (
        jw.CLAMP8, int(jw.INF), jw.QPAD, jw.TPAD)
