"""The port's CPU route for edit distances: ``native/myers_ed.cc``
(``myers_ed``, ``myers_ed_batch_k``) against the JAX package's native
``myers_ed_batch_k``, its numpy oracle and the port's plain K1 (full
window), and the port's CPU engine on that route (``native_cpu``) against
the JAX engine on its CPU route, NW and HW, string and index APIs, with
caps.  ``ISOCON_NO_NATIVE=1`` and a sharder from the caller keep the
plain K1/K2.  Inputs are seeded; tolerance: exact.

``plain_port_routes`` is the pin the other port test files use to keep
their engines on the plain K1/K2/K5.
"""
import contextlib
import functools
import random

import numpy as np
import pytest
import torch

from isocon_tpu import native as jax_native
from isocon_tpu.ops import oracle
from isocon_tpu.ops.engine import PairEngine as JaxEngine
from isocon_tpu_torch import native
from isocon_tpu_torch.ops import engine as port_engine
from isocon_tpu_torch.ops.encode import encode_seq
from isocon_tpu_torch.ops.engine import PairEngine
from isocon_tpu_torch.ops.myers import myers_ed_pool, peq_table
from isocon_tpu_torch.parallel import Sharder

UNCAPPED = 2 ** 31 - 1


@contextlib.contextmanager
def plain_port_routes():
    """Port engines built inside run the plain K1/K2/K5 on the CPU:
    ``ISOCON_NO_NATIVE=1`` while each is constructed.  The JAX engines
    are left on their own routes.  The unpinned constructor stays
    reachable as ``PairEngine.__init__.__wrapped__``."""
    init = PairEngine.__init__

    @functools.wraps(init)
    def pinned(self, *args, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ISOCON_NO_NATIVE", "1")
            init(self, *args, **kw)

    PairEngine.__init__ = pinned
    try:
        yield
    finally:
        PairEngine.__init__ = init


def _rs(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _mut(rng, s, k):
    s = list(s)
    for _ in range(k):
        p = rng.randrange(len(s) + 1)
        op = rng.choice("SID")
        if op == "I" or p == len(s):
            s.insert(p, rng.choice("ACGT"))
        elif op == "S":
            s[p] = rng.choice("ACGT")
        else:
            del s[p]
    return "".join(s)


def _block_pairs(seed=7):
    """Lengths across the 64-bit block boundary, empty sides, identical,
    unrelated and mutated pairs."""
    rng = random.Random(seed)
    pairs = [("", ""), ("", "ACGT"), ("ACG", ""), ("A", "A"), ("A", "C")]
    for n in (1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 191, 192, 300):
        a = _rs(rng, n)
        pairs.append((a, a))
        pairs.append((a, _mut(rng, a, rng.randrange(1, 12))))
        pairs.append((a, _rs(rng, max(1, n + rng.randrange(-20, 21)))))
        pairs.append((_mut(rng, a, 3), a[: n // 2]))
    return pairs


def _codes(s):
    return encode_seq(s).view(np.uint8)


def _planes(pairs):
    B = len(pairs)
    L = max(1, max(max(len(a), len(b)) for a, b in pairs))
    q = np.zeros((B, L), np.uint8)
    t = np.zeros((B, L), np.uint8)
    ql = np.zeros(B, np.int64)
    tl = np.zeros(B, np.int64)
    for i, (a, b) in enumerate(pairs):
        q[i, :len(a)] = _codes(a)
        t[i, :len(b)] = _codes(b)
        ql[i], tl[i] = len(a), len(b)
    return q, ql, t, tl


def _plain_k1(pairs):
    """The port's plain K1 at the full window over a pool of the pairs'
    sequences (pairs with an empty side: max of the lengths)."""
    seqs = sorted({s for p in pairs for s in p if s})
    L = 256
    while L < max(len(s) for s in seqs):
        L *= 2
    mat = np.full((len(seqs) + 1, L), 6, np.uint8)
    lens = np.ones(len(seqs) + 1, np.int32)
    for r, s in enumerate(seqs, 1):
        mat[r, :len(s)] = _codes(s)
        lens[r] = len(s)
    pool, plen = torch.from_numpy(mat), torch.from_numpy(lens)
    row = {s: r for r, s in enumerate(seqs, 1)}
    full = [i for i, (a, b) in enumerate(pairs) if a and b]
    ia = torch.tensor([row[pairs[i][0]] for i in full], dtype=torch.int32)
    ib = torch.tensor([row[pairs[i][1]] for i in full], dtype=torch.int32)
    ed = myers_ed_pool(pool, plen, peq_table(pool, plen), ia, ib, L=L,
                       win=None).numpy()
    out = np.array([max(len(a), len(b)) for a, b in pairs], np.int64)
    out[full] = ed
    return out


def _capped(d, k):
    return np.where((k < 0) | (d <= k), d, -1)


@pytest.fixture(scope="module")
def block_case():
    pairs = _block_pairs()
    want = np.array([oracle.edit_distance(a, b) for a, b in pairs])
    return pairs, want


def test_myers_ed_matches_oracle_and_plain_k1(block_case):
    pairs, want = block_case
    np.testing.assert_array_equal(_plain_k1(pairs), want)
    for (a, b), d in zip(pairs, want):
        ca, cb = _codes(a), _codes(b)
        assert native.myers_ed(ca, cb) == d
        assert native.myers_ed(ca.tobytes(), cb.tobytes(), int(d)) == d
        assert native.myers_ed(ca, cb, int(d) - 1) == (-1 if d > 0 else 0)


@pytest.mark.parametrize("caps", ["none", "-1", "0", "ed-1", "ed", "random"])
def test_myers_ed_batch_k_matches_jax_native_and_oracle(block_case, caps):
    pairs, want = block_case
    rng = np.random.default_rng(11)
    ks = {"none": np.full(len(pairs), UNCAPPED),
          "-1": np.full(len(pairs), -1), "0": np.zeros(len(pairs)),
          "ed-1": want - 1, "ed": want,
          "random": rng.integers(-1, 40, len(pairs))}[caps].astype(np.int64)
    q, ql, t, tl = _planes(pairs)
    got = native.myers_ed_batch_k(q, ql, t, tl, ks)
    np.testing.assert_array_equal(got, jax_native.myers_ed_batch_k(
        q, ql, t, tl, ks))
    np.testing.assert_array_equal(got, _capped(want, ks))
    np.testing.assert_array_equal(got, [
        oracle.edit_distance(a, b, k=None if k < 0 else int(k))
        for (a, b), k in zip(pairs, ks)])


def test_myers_ed_batch_k_long_pairs():
    """17-20 kb pairs (the long workload's lengths), uncapped and capped
    across their distances."""
    rng = random.Random(5)
    pairs = []
    for n in (17000, 18500, 20000):
        a = _rs(rng, n)
        pairs.append((a, _mut(rng, a, rng.randrange(20, 60))))
    want = np.array([oracle.edit_distance(a, b) for a, b in pairs])
    q, ql, t, tl = _planes(pairs)
    for ks in (np.full(3, -1), want, want - 1, np.full(3, 45)):
        ks = ks.astype(np.int64)
        got = native.myers_ed_batch_k(q, ql, t, tl, ks)
        np.testing.assert_array_equal(got, _capped(want, ks))
        np.testing.assert_array_equal(got, jax_native.myers_ed_batch_k(
            q, ql, t, tl, ks))


def test_myers_ed_batch_k_rejects_bad_shapes():
    q = np.zeros((2, 8), np.uint8)
    with pytest.raises(ValueError):
        native.myers_ed_batch_k(q, [1, 9], q, [1, 1], [0, 0])
    with pytest.raises(ValueError):
        native.myers_ed_batch_k(q, [1], q, [1], [0])
    got = native.myers_ed_batch_k(np.zeros((0, 4), np.uint8), [], np.zeros(
        (0, 4), np.uint8), [], [])
    assert got.shape == (0,)


# ---------------------------------------------------------------------------
# the engine's CPU route against the JAX engine's
# ---------------------------------------------------------------------------
def _engine_pairs(seed, n=36):
    rng = random.Random(seed)
    pairs = []
    for i in range(n):
        a = _rs(rng, rng.randrange(40, 400))
        kind = i % 6
        if kind == 0:
            b = _rs(rng, rng.randrange(40, 400))
        elif kind == 1:
            b = a
        elif kind == 2:                     # infix: HW distance small
            b = _rs(rng, 30) + _mut(rng, a, 4) + _rs(rng, 50)
        else:
            b = _mut(rng, a, rng.randrange(0, 60))
        pairs.append((a, b))
    pairs += [("", "ACGT"), ("ACG", ""), ("", ""), ("N" * 5, "NNNNA"),
              (_rs(rng, 700), _rs(rng, 60))]
    return pairs


def _caps(pairs, cap, seed):
    if cap is None:
        return None
    rng = np.random.default_rng(seed)
    return np.minimum(cap, rng.integers(0, 200, len(pairs)))


def _assert_ed_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    known = want[0] >= 0
    np.testing.assert_array_equal(got[1][known], want[1][known])


@pytest.fixture(scope="module")
def jax_cpu_engine():
    eng = JaxEngine()
    assert eng.native_cpu
    return eng


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
@pytest.mark.parametrize("cap", [None, 0, 25, 110])
def test_engine_native_route_matches_jax_cpu_route(jax_cpu_engine, hw_mode,
                                                   cap):
    pairs = _engine_pairs(40 + int(hw_mode))
    caps = _caps(pairs, cap, cap or 1)
    port = PairEngine(device="cpu")
    assert port.native_cpu
    got = port.edit_distances(pairs, k_cap=caps, hw_mode=hw_mode)
    want = jax_cpu_engine.edit_distances(pairs, k_cap=caps, hw_mode=hw_mode)
    _assert_ed_equal(got, want)
    assert port.counters["ed_pairs"] == len(pairs)
    assert not port.myers_rungs and not port.wavefront_rungs
    if cap is None:
        assert (got[0] >= 0).all()
        if not hw_mode:
            for (a, b), d in zip(pairs, got[0]):
                assert d == oracle.edit_distance(a, b)


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
def test_engine_native_index_api_matches_jax(jax_cpu_engine, hw_mode):
    pairs = _engine_pairs(50 + int(hw_mode))
    caps = _caps(pairs, 60, 3)
    seqs = sorted({s for p in pairs for s in p})
    port = PairEngine(device="cpu")
    pos = {s: k for k, s in enumerate(seqs)}
    ia = np.array([pos[a] for a, _ in pairs])
    ib = np.array([pos[b] for _, b in pairs])
    ids_p = port.add_seqs(seqs)
    ids_j = jax_cpu_engine.add_seqs(seqs)
    for k in (None, caps):
        got = port.edit_distances_idx(ids_p[ia], ids_p[ib], k_cap=k,
                                      hw_mode=hw_mode)
        want = jax_cpu_engine.edit_distances_idx(ids_j[ia], ids_j[ib],
                                                 k_cap=k, hw_mode=hw_mode)
        _assert_ed_equal(got, want)
        _assert_ed_equal(got, port.edit_distances(pairs, k_cap=k,
                                                  hw_mode=hw_mode))
    # the host pool interned each sequence once, for both calls
    assert port._host_pool.n <= len(seqs)


def test_engine_native_route_equals_plain_route():
    pairs = _engine_pairs(60)
    caps = _caps(pairs, 80, 4)
    nat = PairEngine(device="cpu")
    plain = PairEngine(device="cpu")
    plain.native_cpu = False
    for hw_mode in (False, True):
        _assert_ed_equal(nat.edit_distances(pairs, k_cap=caps,
                                            hw_mode=hw_mode),
                         plain.edit_distances(pairs, k_cap=caps,
                                              hw_mode=hw_mode))
    assert plain.myers_rungs and not nat.myers_rungs
    assert nat.align_pairs(pairs[:12], [(2, -2, 2, 1)] * 12) == \
        plain.align_pairs(pairs[:12], [(2, -2, 2, 1)] * 12)


def _route_pairs(seed):
    """Six similar pairs: one window each way, no escalation."""
    rng = random.Random(seed)
    pairs = []
    for _ in range(6):
        a = _rs(rng, rng.randrange(80, 160))
        pairs.append((a, _mut(rng, a, 3)))
    return pairs


def _count_plain_calls(monkeypatch):
    """Counts the engine's K1/K2 calls (through the Sharder's launch)."""
    calls = []
    for name in ("myers_ed_pool", "myers_hw_pool"):
        fn = getattr(port_engine, name)

        def counted(*a, _fn=fn, **kw):
            calls.append(_fn.__name__)
            return _fn(*a, **kw)

        monkeypatch.setattr(port_engine, name, counted)

    def native_boom(*a, **kw):
        raise AssertionError("the host route was taken")

    monkeypatch.setattr(native, "myers_ed_batch_k", native_boom)
    monkeypatch.setattr(native, "hw_traceback_batch", native_boom)
    return calls


def test_no_native_env_keeps_the_plain_route(monkeypatch):
    monkeypatch.setenv("ISOCON_NO_NATIVE", "1")
    eng = PairEngine(device="cpu")
    assert not eng.native_cpu
    calls = _count_plain_calls(monkeypatch)
    pairs = _route_pairs(70)
    eng.edit_distances(pairs)
    eng.edit_distances(pairs, hw_mode=True)
    assert "myers_ed_pool" in calls and "myers_hw_pool" in calls


def test_engine_with_a_sharder_keeps_the_plain_route(monkeypatch):
    monkeypatch.delenv("ISOCON_NO_NATIVE", raising=False)
    eng = PairEngine(device="cpu", sharder=Sharder([torch.device("cpu")]))
    assert not eng.native_cpu
    calls = _count_plain_calls(monkeypatch)
    pairs = _route_pairs(71)
    eng.edit_distances(pairs)
    eng.edit_distances(pairs, hw_mode=True)
    assert "myers_ed_pool" in calls and "myers_hw_pool" in calls


def test_native_route_takes_no_plain_kernel(monkeypatch):
    monkeypatch.delenv("ISOCON_NO_NATIVE", raising=False)
    eng = PairEngine(device="cpu")
    assert eng.native_cpu

    def boom(*a, **kw):
        raise AssertionError("a plain kernel ran on the host route")

    for name in ("myers_ed_pool", "myers_hw_pool", "banded_ed_pool"):
        monkeypatch.setattr(port_engine, name, boom)
    pairs = _route_pairs(72)
    eng.edit_distances(pairs)
    eng.edit_distances(pairs, hw_mode=True)


def test_pin_keeps_port_engines_plain_and_jax_engines_native():
    with plain_port_routes():
        assert not PairEngine(device="cpu").native_cpu
        assert JaxEngine().native_cpu
    assert PairEngine(device="cpu").native_cpu
