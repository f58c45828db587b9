"""Port K2 (HW-mode / infix Myers edit distance), the engine's
``edit_distances(hw_mode=True)``, the host HW traceback and
``ends_ignored_nn_graph`` vs the JAX package.

The plain PyTorch version (``isocon_tpu_torch.ops.myers.myers_hw_plain``,
run on CPU tensors) must equal the Pallas kernel in interpret mode on
every entry, certified or not, at the same L; certified entries and the
full-width window must equal the numpy oracle, distance and end column
(the CUDA kernel is held to the plain version in test_torch_cuda.py).
Tolerance: exact (integer DP, strings, dict order).
"""
import random

import numpy as np
import pytest
import torch

from isocon_tpu.graph import end_invariant as jax_ei
from isocon_tpu.native import hw_traceback_batch as jax_hw_traceback_batch
from isocon_tpu.ops import oracle
from isocon_tpu.ops.encode import pad_batch
from isocon_tpu.ops.engine import PairEngine as JaxEngine
from isocon_tpu.ops.myers_pallas import (myers_certifies_hw, myers_hw_pallas,
                                         myers_hw_pool)
from isocon_tpu_torch.graph import end_invariant as port_ei
from isocon_tpu_torch.native import hw_traceback_batch
from isocon_tpu_torch.ops import myers as tm
from isocon_tpu_torch.ops.engine import PairEngine, pool_from_numpy
from test_torch_native import plain_port_routes


@pytest.fixture(scope="module", autouse=True)
def _plain_port_routes():
    """The port's engines in this file keep the plain K1/K2/K5 on the CPU
    (``ISOCON_NO_NATIVE=1``); ``tests/test_torch_native.py`` holds the
    host route."""
    with plain_port_routes():
        yield


def _rs(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _mut(rng, s, k, maxlen=10 ** 9):
    s = list(s)
    for _ in range(k):
        op = rng.choice("SID")
        p = rng.randrange(len(s))
        if op == "S":
            s[p] = rng.choice("ACGT")
        elif op == "I" and len(s) < maxlen:
            s.insert(p, rng.choice("ACGT"))
        elif len(s) > 1:
            del s[p]
    return "".join(s)


def hw_pairs(seed, B, L, tmin, tmax):
    """The mix of the JAX kernel's own HW test: exact substrings, mutated
    substrings, queries longer than the target, comparable noisy pairs,
    unrelated pairs and queries of 1-11 letters."""
    rng = random.Random(seed)
    pairs = []
    for i in range(B):
        t = _rs(rng, rng.randrange(tmin, tmax))
        mode = i % 6
        if mode == 0:
            a, b = sorted(rng.sample(range(len(t)), 2))
            q = t[a:b + 1] or t[:5]
        elif mode == 1:
            a, b = sorted(rng.sample(range(len(t)), 2))
            q = _mut(rng, t[a:b + 1] or t[:20], rng.randrange(0, 12), L - 4)
        elif mode == 2:
            q = _mut(rng, t + _rs(rng, rng.randrange(1, 25)),
                     rng.randrange(0, 6), L - 4)[:L - 4]
        elif mode == 3:
            q = _mut(rng, t, rng.randrange(0, 30), L - 4)
        elif mode == 4:
            q = _rs(rng, rng.randrange(40, tmax - 10))
        else:
            q = _rs(rng, rng.randrange(1, 12))
        pairs.append((q, t))
    return pairs


def _case(seed, B, L, tmin, tmax):
    pairs = hw_pairs(seed, B, L, tmin, tmax)
    q, ql = pad_batch([a for a, _ in pairs], L)
    t, tl = pad_batch([b for _, b in pairs], L)
    pool_np = np.concatenate([q, t])
    plen_np = np.concatenate([ql, tl])
    pool, plen = pool_from_numpy(pool_np.reshape(-1), plen_np, L, "cpu")
    ia = torch.arange(B, dtype=torch.int32)
    return dict(pairs=pairs, q=q, t=t, ql=ql, tl=tl, pool_np=pool_np,
                plen_np=plen_np, pool=pool, plen=plen,
                peq=tm.peq_table(pool, plen), ia=ia, ib=ia + B, L=L, B=B)


@pytest.fixture(scope="module")
def win7():
    return _case(11, 1024, 256, 100, 250)


@pytest.fixture(scope="module")
def win9():
    return _case(12, 1024, 512, 250, 500)


def _port(d, win):
    ed, ej = tm.myers_hw_pool(d["pool"], d["plen"], d["peq"], d["ia"],
                              d["ib"], L=d["L"], win=win)
    return ed.numpy(), ej.numpy()


@pytest.mark.parametrize("case,win", [("win7", 7), ("win9", 9)])
def test_hw_plain_matches_pallas_interpret(case, win, request):
    d = request.getfixturevalue(case)
    wed, wej = myers_hw_pallas(d["q"], d["t"], d["ql"], d["tl"], L=d["L"],
                               interpret=True, win=win)
    ed, ej = _port(d, win)
    np.testing.assert_array_equal(ed, np.asarray(wed))
    np.testing.assert_array_equal(ej, np.asarray(wej))
    cert = myers_certifies_hw(ed, d["ql"], d["tl"], win=win)
    assert 0 < cert.sum() < d["B"]  # certified and uncertified entries


def test_hw_plain_matches_jax_pool(win7):
    d = win7
    ia = np.arange(d["B"], dtype=np.int32)
    wed, wej = myers_hw_pool(d["pool_np"].reshape(-1), d["plen_np"], ia,
                             ia + d["B"], L=d["L"], interpret=True)
    ed, ej = _port(d, 7)
    np.testing.assert_array_equal(ed, np.asarray(wed))
    np.testing.assert_array_equal(ej, np.asarray(wej))


@pytest.mark.parametrize("case,win", [("win7", 7), ("win9", 9)])
def test_hw_certified_entries_equal_oracle(case, win, request):
    d = request.getfixturevalue(case)
    ed, ej = _port(d, win)
    cert = tm.myers_certifies_hw(ed, d["ql"], d["tl"], win=win)
    np.testing.assert_array_equal(
        cert, myers_certifies_hw(ed, d["ql"], d["tl"], win=win))
    checked = 0
    for i in range(0, d["B"], 5):
        if cert[i]:
            want, _s0, e0, _ops = oracle.edit_distance_hw(*d["pairs"][i])
            assert (ed[i], ej[i]) == (want, e0 + 1), i
            checked += 1
    assert checked > 30


def test_hw_full_window_equals_oracle(win7):
    d = win7
    ed, ej = _port(d, None)
    for i in range(0, d["B"], 5):
        want, _s0, e0, _ops = oracle.edit_distance_hw(*d["pairs"][i])
        assert (ed[i], ej[i]) == (want, e0 + 1), i


# ---------------------------------------------------------------------------
# engine: edit_distances(hw_mode=True)
# ---------------------------------------------------------------------------
def _engine_pairs(seed, n=90):
    """Substrings, unrelated pairs (these escalate past window 7), noisy
    copies, short queries in long targets, and empty sides."""
    rng = random.Random(seed)
    pairs = []
    for i in range(n):
        t = _rs(rng, rng.randrange(150, 400))
        if i % 3 == 0:
            a, b = sorted(rng.sample(range(len(t)), 2))
            q = t[a:b + 1] or t[:10]
        elif i % 3 == 1:
            q = _rs(rng, rng.randrange(100, 400))
        else:
            ql = list(t)
            for p in rng.sample(range(len(t)), len(t) // 10):
                ql[p] = rng.choice("ACGT")
            q = "".join(ql)
        pairs.append((q, t))
    pairs += [("", "ACGT"), ("ACG", ""), ("", ""), ("A", "A"),
              ("ACGTN" * 3, "TT" + "ACGTA" * 3 + "GG")]
    return pairs


# the JAX engine sends HW rounds of <= 256 pairs to its native library
KERNEL_ROUND = 300


def _jax_kernel_engine(monkeypatch):
    """The JAX engine on its kernel path, as its own tests set it."""
    monkeypatch.setenv("ISOCON_NO_NATIVE", "1")
    eng = JaxEngine(batch_pairs=128, use_pallas=True, ed_batch=1024,
                    interpret=True)
    eng.pallas_L0 = 512
    return eng


def _assert_hw_equal(got, want):
    (ed, ej), (wed, wej) = got, want
    np.testing.assert_array_equal(ed, wed)
    known = wed >= 0        # end_j is defined where the distance is
    np.testing.assert_array_equal(ej[known], wej[known])


def test_engine_hw_matches_jax_kernel_path(monkeypatch):
    pairs = _engine_pairs(23, KERNEL_ROUND)
    want = _jax_kernel_engine(monkeypatch).edit_distances(pairs,
                                                          hw_mode=True)
    port = PairEngine(device="cpu")
    got = port.edit_distances(pairs, hw_mode=True)
    _assert_hw_equal(got, want)
    for (q, t), d, e in zip(pairs, *got):
        wd, _s0, e0, _ops = oracle.edit_distance_hw(q, t)
        assert (d, e) == (wd, e0 + 1 if q and t else 0), (q[:8], t[:8])
    assert (got[0] > 96).any()      # really escalated past window 7


@pytest.mark.parametrize("cap", [0, 10, 25, 110])
def test_engine_hw_k_cap_matches_jax_kernel_path(monkeypatch, cap):
    pairs = _engine_pairs(24, KERNEL_ROUND)
    rng = np.random.default_rng(cap)
    caps = np.minimum(cap, rng.integers(0, 200, len(pairs)))
    want = _jax_kernel_engine(monkeypatch).edit_distances(
        pairs, k_cap=caps, hw_mode=True)
    got = PairEngine(device="cpu").edit_distances(pairs, k_cap=caps,
                                                  hw_mode=True)
    _assert_hw_equal(got, want)
    assert (got[0] >= 0).any() and (got[0] < 0).any()


@pytest.mark.parametrize("cap", [None, 25])
def test_engine_hw_matches_jax_native_path(cap):
    pairs = _engine_pairs(25)
    caps = None if cap is None else np.full(len(pairs), cap)
    want = JaxEngine().edit_distances(pairs, k_cap=caps, hw_mode=True)
    got = PairEngine(device="cpu").edit_distances(pairs, k_cap=caps,
                                                  hw_mode=True)
    _assert_hw_equal(got, want)


def test_engine_hw_index_api():
    pairs = [p for p in _engine_pairs(26) if p[0] and p[1]]
    port = PairEngine(device="cpu")
    seqs = sorted({s for p in pairs for s in p})
    ids = port.add_seqs(seqs)
    pos = {s: k for k, s in enumerate(seqs)}
    ia = ids[[pos[a] for a, _ in pairs]]
    ib = ids[[pos[b] for _, b in pairs]]
    got = port.edit_distances_idx(ia, ib, hw_mode=True)
    want = PairEngine(device="cpu").edit_distances(pairs, hw_mode=True)
    _assert_hw_equal(got, want)


# ---------------------------------------------------------------------------
# host traceback
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tb_pairs():
    pairs = hw_pairs(31, 120, 256, 100, 250)
    pairs += [("", "ACGT"), ("ACG", ""), ("", "")]
    want = [oracle.edit_distance_hw(q, t) for q, t in pairs]
    return pairs, want


def test_hw_traceback_matches_oracle_and_jax(tb_pairs):
    pairs, want = tb_pairs
    got = hw_traceback_batch(pairs)
    assert got == jax_hw_traceback_batch(pairs)
    for g, w, (q, t) in zip(got, want, pairs):
        if q and t:
            assert g == tuple(w), (q, t)


@pytest.mark.parametrize("hint", ["exact", "too_small", "mixed"])
def test_hw_traceback_ed_hint(tb_pairs, hint):
    pairs, want = tb_pairs
    exact = [w[0] for w in want]
    hints = {"exact": exact, "too_small": [0] * len(pairs),
             "mixed": [d if i % 2 else -1 for i, d in enumerate(exact)]}[hint]
    got = hw_traceback_batch(pairs, ed_hint=hints)
    assert got == jax_hw_traceback_batch(pairs, ed_hint=hints)
    assert got == hw_traceback_batch(pairs)    # a hint never changes it


@pytest.mark.parametrize("cap", [0, 3, 25, -1])
def test_hw_traceback_k_cap(tb_pairs, cap):
    pairs, want = tb_pairs
    caps = [cap] * len(pairs)
    got = hw_traceback_batch(pairs, band=64, k_cap=caps)
    assert got == jax_hw_traceback_batch(pairs, band=64, k_cap=caps)
    free = hw_traceback_batch(pairs)
    for g, f in zip(got, free):
        assert g == (f if cap < 0 or f[0] <= cap else (-1, 0, 0, ""))
    if cap >= 0:
        assert (-1, 0, 0, "") in got


def test_hw_traceback_empty_batch():
    assert hw_traceback_batch([]) == []


# ---------------------------------------------------------------------------
# ends-ignored candidate graph
# ---------------------------------------------------------------------------
def _graph_candidates(seed):
    """About 60 candidates of three families: SNV haplotypes, end
    overhangs, leading and trailing insertions, and lengths that straddle
    the length window (40) of the pair collection."""
    rng = random.Random(seed)
    cands = {}
    k = 0
    for fam in range(3):
        base = _rs(rng, 300 + 35 * fam)
        for v in range(20):
            kind = v % 5
            if kind == 0:
                s = _mut(rng, base, rng.randrange(0, 4))
            elif kind == 1:     # end overhangs, within and past 15
                s = (_rs(rng, rng.randrange(0, 25)) + base
                     + _rs(rng, rng.randrange(0, 25)))
            elif kind == 2:     # clipped ends
                s = base[rng.randrange(0, 22): len(base)
                         - rng.randrange(0, 22)]
            elif kind == 3:     # internal variants beside an overhang
                s = _rs(rng, 8) + _mut(rng, base, rng.randrange(3, 14))
            else:               # straddles the window
                s = base + _rs(rng, rng.randrange(30, 50))
            if s not in cands.values():
                cands["transcript_%d_support_%d" % (k, 3 + v)] = s
                k += 1
    return cands


@pytest.mark.parametrize("seed,ignore_ends_len,depth",
                         [(41, 15, None), (42, 15, 3), (43, 0, None)])
def test_ends_ignored_nn_graph_matches(seed, ignore_ends_len, depth):
    cands = _graph_candidates(seed)
    want = jax_ei.ends_ignored_nn_graph(cands, ignore_ends_len, JaxEngine(),
                                        neighbor_search_depth=depth)
    port = PairEngine(device="cpu")
    got = port_ei.ends_ignored_nn_graph(cands, ignore_ends_len, port,
                                        neighbor_search_depth=depth)
    assert got == want
    assert list(got) == list(want)
    for acc in want:
        assert list(got[acc].items()) == list(want[acc].items()), acc
    assert sum(len(v) for v in want.values()) > 20
    assert any(not v for v in want.values()) or depth is None
    assert port.counters["hw_survivors"] > 0


class _RecordingEngine:
    """Records the static graph's HW edit-distance call and answers every
    pair with -1 (no survivor)."""

    def __init__(self):
        self.counters = {"hw_survivors": 0, "hw_traceback_seconds": 0.0}
        self.seqs, self.calls = [], []

    def add_seqs(self, seqs):
        self.seqs = list(seqs)
        return np.arange(len(self.seqs), dtype=np.int32)

    def edit_distances_idx(self, ia, ib, k_cap=None, hw_mode=False):
        self.calls.append((np.asarray(ia), np.asarray(ib), hw_mode))
        return (np.full(len(ia), -1, np.int32), np.zeros(len(ia), np.int32))


def test_static_graph_pairs_are_the_engines_launch(tmp_path, monkeypatch):
    """The port's ``static_graph_pairs`` gives the pairs, and the order,
    that the JAX and the port's ``ends_ignored_nn_graph`` send to the
    engine's HW edit distances; ``chip_smoke.static_graph_batch`` lays them
    out as rows of the candidates in length order, and
    ``chip_smoke.static_graph_launches`` groups them by the engine's pool
    width and cuts each group at its ``ED_BATCH`` (shrunk here) into
    launches on that group's pool."""
    import chip_smoke
    from isocon_tpu_torch.ops import engine as port_engine

    cands = _graph_candidates(44)
    rng = random.Random(45)     # lengths 236-276: pools of 256 and 512
    cands.update(("short_%d_support_3" % i, _rs(rng, 236 + 4 * i))
                 for i in range(11))
    jax_rec, port_rec = _RecordingEngine(), _RecordingEngine()
    jax_ei.ends_ignored_nn_graph(cands, 15, jax_rec)
    port_ei.ends_ignored_nn_graph(cands, 15, port_rec)
    ordered, wanted = port_ei.static_graph_pairs(cands, 15)
    (ia, ib, hw), = jax_rec.calls
    assert hw and port_rec.calls[0][2]
    w = np.asarray(wanted)
    for rec in (jax_rec, port_rec):
        ria, rib, _hw = rec.calls[0]
        seqs = [rec.seqs[i] for i in ria], [rec.seqs[i] for i in rib]
        assert seqs == ([ordered[i][0] for i in w[:, 0]],
                        [ordered[i][0] for i in w[:, 1]])
    path = tmp_path / "candidates.fa"
    path.write_text("".join(">%s\n%s\n" % kv for kv in cands.items()))
    codes, lens, bia, bib = chip_smoke.static_graph_batch(np, str(path))
    assert codes.shape == (len(ordered), 512)
    assert np.array_equal(bia, w[:, 0]) and np.array_equal(bib, w[:, 1])
    assert ["".join("ACGTXN"[c] for c in codes[i, :lens[i]])
            for i in range(len(ordered))] == [sq for sq, _a in ordered]
    monkeypatch.setattr(port_engine, "ED_BATCH", 100)
    launches = list(chip_smoke.static_graph_launches(
        torch, np, tm, torch.device("cpu"), (codes, lens, bia, bib)))
    widths = port_engine._pool_widths(np.maximum(lens[bia], lens[bib]))
    order = np.concatenate([np.flatnonzero(widths == Lb)
                            for Lb in np.unique(widths)])
    assert np.unique(widths).size == 2       # pools of 256 and 512
    assert [c[2].shape[0] for c in launches] == [
        min(100, k - s) for Lb in np.unique(widths)
        for k in [int((widths == Lb).sum())] for s in range(0, k, 100)]
    got_q = np.concatenate([c[2].numpy() for c in launches])
    assert np.array_equal(got_q, bia[order])
    plen = torch.from_numpy(lens)
    for pool, peq, qrow, trow, n, m in launches:
        Lb = pool.shape[1]
        assert torch.equal(peq, tm.peq_table(pool, plen))
        assert torch.equal(pool, torch.from_numpy(codes[:, :Lb]))
        assert torch.equal(n, plen[qrow.long()])
        assert torch.equal(m, plen[trow.long()])
        assert bool((torch.maximum(n, m) > Lb // 2).all())


def test_adjust_hw_distance_matches():
    rng = random.Random(5)
    for _ in range(200):
        ops = "".join(rng.choice("=XDI") for _ in range(rng.randrange(0, 30)))
        args = (rng.randrange(0, 40), ops, rng.randrange(0, 40),
                rng.randrange(0, 60), rng.randrange(60, 100),
                rng.randrange(0, 20))
        assert (port_ei._adjust_hw_distance(*args)
                == jax_ei._adjust_hw_distance(*args))
