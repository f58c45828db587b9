"""The port's PairEngine (plain kernels, ``device="cpu"``) vs the JAX
package's PairEngine on the same pair lists: edit distances under
``k_cap``, empty and trivial pairs, window escalation up to the full-width
window, and affine alignments whose band overflows and doubles.
Tolerance: exact.
"""
import functools
import inspect
import random

import numpy as np
import pytest
import torch

from isocon_tpu.ops.engine import PairEngine as JaxEngine
from isocon_tpu_torch import cli as port_cli
from isocon_tpu_torch.ops import oracle
from isocon_tpu_torch.ops.encode import encode_seq
from isocon_tpu_torch.ops.engine import PairEngine, pool_from_numpy
from isocon_tpu_torch.ops.myers import peq_table
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


def _mut(rng, s, k):
    s = list(s)
    for _ in range(k):
        p = rng.randrange(len(s))
        op = rng.choice("SID")
        if op == "S":
            s[p] = rng.choice("ACGT")
        elif op == "I":
            s.insert(p, rng.choice("ACGT"))
        elif len(s) > 1:
            del s[p]
    return "".join(s)


def _ed_pairs(seed):
    rng = random.Random(seed)
    pairs = []
    for i in range(40):
        a = _rs(rng, rng.randrange(150, 400))
        kind = i % 5
        if kind == 0:
            b = _rs(rng, rng.randrange(150, 400))    # unrelated: escalates
        elif kind == 1:
            b = a                                    # trivial
        else:
            b = _mut(rng, a, rng.randrange(0, 60))
        pairs.append((a, b))
    pairs += [("", "ACGT"), ("ACG", ""), ("", ""), ("A", "A"), ("N", "N"),
              ("ACGTN" * 3, "ACGTA" * 3)]
    # length difference past every Myers window: full-width window
    pairs.append((_rs(rng, 700), _rs(rng, 60)))
    return pairs


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine()


def test_edit_distances_match(jax_engine):
    pairs = _ed_pairs(1)
    port = PairEngine(device="cpu")
    got, gej = port.edit_distances(pairs)
    want, wej = jax_engine.edit_distances(pairs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gej, wej)
    assert port.counters["ed_pairs_full_window"] >= 1


@pytest.mark.parametrize("cap", [0, 5, 40, 120])
def test_edit_distances_k_cap_match(jax_engine, cap):
    pairs = _ed_pairs(2)
    rng = np.random.default_rng(cap)
    caps = np.minimum(cap, rng.integers(0, 200, len(pairs)))
    port = PairEngine(device="cpu")
    got, _ = port.edit_distances(pairs, k_cap=caps)
    want, _ = jax_engine.edit_distances(pairs, k_cap=caps)
    np.testing.assert_array_equal(got, want)


def test_index_api_matches(jax_engine):
    pairs = _ed_pairs(3)
    seqs = sorted({s for p in pairs for s in p})
    port = PairEngine(device="cpu")
    ids_p = port.add_seqs(seqs)
    ids_j = jax_engine.add_seqs(seqs)
    pos = {s: k for k, s in enumerate(seqs)}
    ia = np.array([pos[a] for a, _ in pairs])
    ib = np.array([pos[b] for _, b in pairs])
    np.testing.assert_array_equal(port.table_lens(ids_p[ia]),
                                  jax_engine.table_lens(ids_j[ia]))
    got, _ = port.edit_distances_idx(ids_p[ia], ids_p[ib])
    want, _ = jax_engine.edit_distances_idx(ids_j[ia], ids_j[ib])
    np.testing.assert_array_equal(got, want)


def _align_case(seed, drift):
    """Mutated pairs plus, every third pair, one whose optimal path leaves
    the first band: an overlap at offset +-128 (on the band edge: the walk
    flags overflow and the band doubles) or, with ``drift``, a 200-char
    insertion then deletion (the path leaves the band in the middle)."""
    rng = random.Random(seed)
    pairs = []
    for i in range(24):
        core = _rs(rng, 400)
        if i % 3 == 0 and drift:
            pairs.append((core + _rs(rng, 100), _mut(
                rng, core[:100] + _rs(rng, 200) + core[100:300], 2)))
        elif i % 6 == 0:
            pairs.append((core, _rs(rng, 128) + core[:272]))
        elif i % 6 == 3:
            pairs.append((_rs(rng, 127) + core[:273], core))
        else:
            a = core[:rng.randrange(200, 350)]
            pairs.append((a, _mut(rng, a, rng.randrange(0, 20))))
    pairs.append(("", "ACGT"))
    scores = [(2, (-1, -2, -4)[i % 3], 2, (0, 1)[i % 2])
              for i in range(len(pairs))]
    return pairs, scores


def test_align_pairs_match_with_overflow(jax_engine):
    pairs, scores = _align_case(5, drift=False)
    port = PairEngine(device="cpu")
    got = port.align_pairs(pairs, scores)
    want = jax_engine.align_pairs(pairs, scores)
    assert got == want
    assert port.counters["align_overflows"] > 0
    # ed hints widen the first band; the results stay the same
    eds, _ = jax_engine.edit_distances(pairs)
    assert port.align_pairs(pairs, scores, ed_hint=eds) == want


def test_align_pairs_match_jax_banded_path(monkeypatch):
    """Against the JAX engine's banded kernel path (lax.scan affine, native
    CPU routing off), including paths that leave the band without touching
    its edge: there both keep the best in-band alignment, which can differ
    from the full DP of the native CPU path."""
    monkeypatch.setenv("ISOCON_NO_NATIVE", "1")
    pairs, scores = _align_case(9, drift=True)
    want = JaxEngine().align_pairs(pairs, scores)
    assert PairEngine(device="cpu").align_pairs(pairs, scores) == want


def _rows_route_case(case):
    """(pairs, scores, pairs whose strings the codes do not give back) of
    one case of ``test_align_rows_route_and_counters``."""
    if case == "overflow":
        pairs, scores = _align_case(5, drift=False)
        return pairs, scores, set()
    rng = random.Random(17)
    pairs = []
    for i in range(18):
        a = _rs(rng, rng.randrange(150, 400))
        pairs.append((a, _mut(rng, a[rng.randrange(0, 30):],
                              rng.randrange(0, 25))))
    pairs[4] = (pairs[4][0][:50] + "N" + pairs[4][0][51:], pairs[4][1])
    host = set()
    if case == "mixed":
        a, b = pairs[2]
        pairs[2] = (a.lower(), b)                        # lowercase query
        a, b = pairs[7]
        pairs[7] = (a, b[:60] + "R" + b[61:])            # IUPAC in target
        a, b = pairs[11]
        pairs[11] = (a[:30] + "acgt" + a[34:], b.lower())
        host = {2, 7, 11}
    scores = [(2, (-1, -2, -4)[i % 3], 2, (0, 1)[i % 2])
              for i in range(len(pairs))]
    return pairs, scores, host


@pytest.mark.parametrize("case,index", [("acgt", False), ("acgt", True),
                                        ("mixed", False), ("mixed", True),
                                        ("overflow", False)])
def test_align_rows_route_and_counters(monkeypatch, case, index):
    """Pairs whose strings hold only A, C, G, T and N take their strings
    and counts from K4's rows as they are (``align_card_rows``); a pair
    with a lowercase or IUPAC letter on either side has its rows spelt
    with its own letters and its counts taken again on the host
    (``align_host_rows``), and only that pair; a pair whose band overflows
    is counted once, after its retry; an empty side is counted in
    neither.  Every result equals the JAX engine's banded path, by
    the string API and by the index API; ``stats_line`` prints both
    counts."""
    monkeypatch.setenv("ISOCON_NO_NATIVE", "1")
    pairs, scores, host = _rows_route_case(case)
    want = JaxEngine().align_pairs(pairs, scores)
    port = PairEngine(device="cpu")
    if index:
        seqs = sorted({s for p in pairs for s in p})
        ids = port.add_seqs(seqs)
        pos = {s: ids[k] for k, s in enumerate(seqs)}
        got = port.align_pairs_idx(np.array([pos[a] for a, _ in pairs]),
                                   np.array([pos[b] for _, b in pairs]),
                                   scores)
    else:
        got = port.align_pairs(pairs, scores)
    assert got == want
    c = port.counters
    empty = sum(1 for a, b in pairs if not a or not b)
    assert c["align_host_rows"] == len(host)
    assert c["align_card_rows"] == len(pairs) - empty - len(host)
    assert (c["align_overflows"] > 0) == (case == "overflow")
    assert "%d card rows, %d host rows" % (
        c["align_card_rows"], c["align_host_rows"]) in port.stats_line()


def test_stats_line_and_counters():
    port = PairEngine(device="cpu")
    port.edit_distances([("ACGT", "ACGA")])
    port.align_pairs([("ACGT", "ACGA")], [(2, -2, 2, 0)])
    assert port.counters["ed_pairs"] == 1
    assert port.counters["align_pairs"] == 1
    assert "1 EDs" in port.stats_line()


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert PairEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            PairEngine()


def test_pool_from_numpy_layout():
    flat = np.arange(12, dtype=np.int8) % 7
    mat, lens = pool_from_numpy(flat, np.array([4, 2, 1]), 4, "cpu")
    assert mat.dtype == torch.uint8 and lens.dtype == torch.int32
    assert mat.shape == (3, 4)
    np.testing.assert_array_equal(mat.numpy(), flat.reshape(3, 4))


def _assert_pool_rows(pool, seqs, rows):
    """Each given sequence sits in its given row with its length and
    Peq."""
    mat, lens, peq = pool.tensors()
    assert mat.shape[0] == lens.shape[0] == peq.shape[0] == pool.n
    rows = torch.as_tensor(np.asarray(rows, dtype=np.int64))
    for s, r in zip(seqs, rows.tolist()):
        e = encode_seq(s).view(np.uint8)
        assert int(lens[r]) == len(s)
        np.testing.assert_array_equal(mat[r, :len(e)].numpy(), e)
        assert (mat[r, len(e):] == 6).all()
    assert torch.equal(peq[rows], peq_table(mat[rows], lens[rows]))


def test_seq_pool_reserved_beyond_host_cap():
    """``reserve_pool_rows`` past a pool's starting capacity, then rows
    taken through the engine's table-id row map in several pushes (one of
    them past the reserved capacity, so the pool grows): rows, lengths and
    Peq planes stay right, in a pool made after the call and in one made
    before it, and an id asked for again keeps its row."""
    rng = random.Random(7)
    seqs = sorted({_rs(rng, rng.randrange(10, 60)) for _ in range(6000)})
    eng = PairEngine(device="cpu")
    early = eng._get_pool(64)           # made before the reservation
    assert early.mat.shape[0] == 1024
    eng.reserve_pool_rows(5000)         # stat_filter reserves 2 x the reads
    eng.reserve_pool_rows(100)          # a smaller request never shrinks it
    late = eng._get_pool(128)
    assert late.mat.shape[0] == late.peq.shape[0] == 5000
    ids = eng.add_seqs(seqs)
    for pool in (early, late):
        rows = eng._pool_rows_for(pool, pool.L, ids[:3000])
        _assert_pool_rows(pool, seqs[:3000:97], rows[::97])
        first = pool.tensors()[0][:3001].clone()
        # crosses 1024 x 2^k and 5000 rows
        rows = eng._pool_rows_for(pool, pool.L, ids)
        assert eng._pool_rows_for(pool, pool.L, ids[:1])[0] == rows[0]
        _assert_pool_rows(pool, seqs[::97] + seqs[-5:],
                          np.concatenate([rows[::97], rows[-5:]]))
        assert pool.n == len(seqs) + 1 <= pool.mat.shape[0]
        assert torch.equal(pool.tensors()[0][:3001], first)
    # through the engine: one call interns every sequence into the
    # 256-wide pool, past its reserved 5000 rows
    pairs = [(seqs[i], seqs[i + 1]) for i in range(len(seqs) - 1)]
    got, _ = eng.edit_distances(pairs)
    assert eng._get_pool(256).mat.shape[0] == 10000
    want, _ = JaxEngine().edit_distances(pairs)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# one body on table ids behind both call surfaces
# ---------------------------------------------------------------------------
def _volume(counters):
    """The engine counters that count (all but the seconds)."""
    return {k: v for k, v in counters.items() if not k.endswith("seconds")}


@pytest.mark.parametrize("route,native", [
    ("nw", False), ("nw", True), ("hw", False), ("hw", True),
    ("align", False)], ids=["nw_plain", "nw_native", "hw_plain",
                            "hw_native", "align_plain"])
def test_string_and_id_calls_agree(route, native):
    """A string call registers its strings and runs the id call's body: on
    the same pairs (each sequence on both sides and more than once; empty
    sides, caps, band overflows and letters the codes do not give back
    among them) the two surfaces give equal outputs and equal counters,
    a sequence has one table id, and it holds one row in each pool it
    entered, and one in the CPU route's host pool."""
    if route == "align":
        pairs = (_rows_route_case("mixed")[0]
                 + _align_case(5, drift=False)[0][-8:])
    else:
        pairs = _ed_pairs(4)[20:-1]
    pairs = pairs + [(b, a) for a, b in pairs[::-1]]
    caps = np.random.default_rng(4).integers(0, 60, len(pairs))
    scores = [(2, (-1, -2, -4)[i % 3], 2, (0, 1)[i % 2])
              for i in range(len(pairs))]
    runs = []
    for by_id in (False, True):
        eng = PairEngine(device="cpu")
        eng.native_cpu = native
        if by_id:
            ia = eng.add_seqs([a for a, _ in pairs])
            ib = eng.add_seqs([b for _, b in pairs])
            out = (eng.align_pairs_idx(ia, ib, scores) if route == "align"
                   else eng.edit_distances_idx(ia, ib, k_cap=caps,
                                               hw_mode=route == "hw"))
        else:
            out = (eng.align_pairs(pairs, scores) if route == "align"
                   else eng.edit_distances(pairs, k_cap=caps,
                                           hw_mode=route == "hw"))
        runs.append((eng, out))
    (by_str, got), (by_ids, want) = runs
    if route == "align":
        assert got == want
        assert by_str.counters["align_host_rows"] > 0
        assert by_str.counters["align_overflows"] > 0
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert (got[0] >= 0).any() and (got[0] < 0).any()
    assert _volume(by_str.counters) == _volume(by_ids.counters)
    distinct = {s for p in pairs for s in p}
    for eng, _ in runs:
        assert sorted(eng._tab_seqs) == sorted(distinct)
        for Lb, pool in eng._pools.items():
            rm = eng._tab_pool_rows[Lb]
            held = np.flatnonzero(rm >= 0)
            assert sorted(rm[held].tolist()) == list(range(1, pool.n))
            _assert_pool_rows(pool, [eng._tab_seqs[t] for t in held],
                              rm[held])
        if eng._tab_host_rows is not None:
            rm = eng._tab_host_rows
            assert sorted(rm[rm >= 0].tolist()) == list(
                range(eng._host_pool.n))
    assert bool(by_str._pools) == (not native)
    assert (by_str._host_pool.n > 0) == (native and route == "nw")


def test_entries_see_every_pair_as_a_benchmark_hooks_them(tmp_path,
                                                          monkeypatch):
    """``PairEngine.edit_distances`` and ``align_pairs``, wrapped by name
    and their arguments bound by name (``pairs``, ``k_cap``, ``hw_mode``,
    ``lens``, ``scores``) as a benchmark's recorder does, see every pair of
    a small CPU pipeline, whether the caller passed strings or table ids:
    the wrapped calls' pairs sum to the engine's ``ed_pairs`` and
    ``align_pairs``, and each ``pairs[i]`` is two strings of the lengths
    ``lens`` gives."""
    seen = {"ed": 0, "align": 0, "by_str": 0, "by_ids": 0}

    def hooked(kind, orig):
        sig = inspect.signature(orig)

        @functools.wraps(orig)
        def wrapped(engine, *args, **kwargs):
            bound = sig.bind(engine, *args, **kwargs)
            bound.apply_defaults()
            arg = bound.arguments
            pairs, lens = arg["pairs"], arg["lens"]
            if kind == "ed":
                assert isinstance(arg["hw_mode"], bool)
                assert arg["k_cap"] is None or len(arg["k_cap"]) == len(pairs)
            else:
                assert len(arg["scores"]) == len(pairs)
            for i in range(len(pairs)):
                a, b = pairs[i]
                assert isinstance(a, str) and isinstance(b, str)
                if lens is not None:
                    assert (len(a), len(b)) == (lens[0][i], lens[1][i])
            seen[kind] += len(pairs)
            seen["by_str" if lens is None else "by_ids"] += 1
            return orig(engine, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(PairEngine, "edit_distances",
                        hooked("ed", PairEngine.edit_distances))
    monkeypatch.setattr(PairEngine, "align_pairs",
                        hooked("align", PairEngine.align_pairs))
    rng = random.Random(23)
    base = _rs(rng, 180)
    variant = base[:60] + ("C" if base[60] != "C" else "G") + base[61:]
    reads = str(tmp_path / "reads.fa")
    with open(reads, "w") as fh:
        for k in range(24):
            iso = base if k % 2 else variant
            fh.write(">r%d\n%s\n" % (k, _mut(rng, iso, rng.randrange(0, 3))))
    engine, _phase1 = port_cli.main(["pipeline", "-fl_reads", reads,
                                     "-outfolder", str(tmp_path / "out"),
                                     "--device", "cpu"])
    assert seen["ed"] == engine.counters["ed_pairs"] > 0
    assert seen["align"] == engine.counters["align_pairs"] > 0
    assert seen["by_str"] > 0 and seen["by_ids"] > 0


# ---------------------------------------------------------------------------
# the long-bucket route: pools wider than MYERS_MAX_L run the banded
# wavefront (K5's plain version here) at every band
# ---------------------------------------------------------------------------
def _long_bucket_pairs(seed, n=150):
    """Pairs of 130-250 bases (pool width 256): copies that certify at band
    128, more divergent copies and copies with a 40-90 base gap (these
    escalate to 256 and 512), unrelated pairs (these give up under a cap),
    exact and noisy infixes, and empty sides."""
    rng = random.Random(seed)
    pairs = []
    for i in range(n):
        a = _rs(rng, rng.randrange(180, 250))
        kind = i % 6
        if kind == 0:
            b = _mut(rng, a, rng.randrange(0, 25))
        elif kind == 1:
            b = _mut(rng, a, rng.randrange(50, 90))[:250]
        elif kind == 2:
            cut = rng.randrange(20, 80)
            b = _mut(rng, a[:cut] + a[cut + rng.randrange(40, 90):], 5)
        elif kind == 3:
            b = _rs(rng, rng.randrange(130, 170))
            a = a[:rng.randrange(130, 150)]
        elif kind == 4:
            b = (_rs(rng, 20) + a + _rs(rng, rng.randrange(0, 20)))[:250]
            a = _mut(rng, a[:200], rng.randrange(0, 12))
        else:
            a, b = a[:rng.randrange(130, 170)], a
        pairs.append((a, b))
    pairs += [("", "ACGT" * 40), ("ACG" * 50, ""), ("", "")]
    return pairs


def _jax_wavefront_engine(monkeypatch):
    """The JAX engine on its pooled-wavefront path: a ``myers_sub`` below 8
    closes the Myers gate, so every band runs ``banded_ed_pool``, the
    Pallas kernel (interpret mode) at Wp = 128 and the scan above; its
    native library is hidden, so small rounds take that path too."""
    import isocon_tpu.native as jax_native

    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    eng = JaxEngine(batch_pairs=128, use_pallas=True, ed_batch=128,
                    interpret=True)
    eng.pallas_L0 = 256
    eng.native_cpu = False
    return eng


@pytest.fixture
def long_bucket(monkeypatch):
    from isocon_tpu_torch.ops import engine as te

    monkeypatch.setattr(te, "MYERS_MAX_L", 128)


@pytest.mark.parametrize("hw_mode", [False, True], ids=["nw", "hw"])
@pytest.mark.parametrize("cap", [None, 30, 140])
def test_long_bucket_route_matches_jax_wavefront_path(long_bucket, cap,
                                                      hw_mode, monkeypatch):
    pairs = _long_bucket_pairs(31 + int(hw_mode))
    caps = None
    if cap is not None:
        rng = np.random.default_rng(cap)
        caps = np.minimum(cap, rng.integers(0, 300, len(pairs)))
    want = _jax_wavefront_engine(monkeypatch).edit_distances(
        pairs, k_cap=caps, hw_mode=hw_mode)
    port = PairEngine(device="cpu")
    got = port.edit_distances(pairs, k_cap=caps, hw_mode=hw_mode)
    np.testing.assert_array_equal(got[0], want[0])
    known = want[0] >= 0
    np.testing.assert_array_equal(got[1][known], want[1][known])
    rungs = {Wp for _mode, Wp in port.wavefront_rungs}
    # every pair that reached a kernel ran the wavefront (NW pairs whose
    # length difference exceeds their cap reach none)
    assert port.counters["ed_pairs_wavefront"] > len(pairs) // 3
    assert port.counters["ed_pairs_full_window"] == 0
    if cap is None:
        # certified at 128, escalated once (NW) or twice (HW)
        assert ({128, 256, 512} if hw_mode else {128, 256}) <= rungs
        assert known.all()
    else:
        assert (~known).any() and known.any()  # some gave up under the cap
    for (a, b), d, e in zip(pairs, *got):
        if d >= 0 and a and b:
            if hw_mode:
                wd, _s0, e0, _ops = oracle.edit_distance_hw(a, b)
                assert (d, e) == (wd, e0 + 1)
            else:
                assert d == oracle.edit_distance(a, b)


def test_long_bucket_route_gives_up_at_the_small_ceiling_as_jax_does(
        long_bucket, monkeypatch):
    """A pair of distance 120 .. 126 under a cap of 126: band 128 clamps it
    at 120 and cannot certify it, and the JAX engine's wavefront path gives
    it up there as -1 although it meets the cap (its floor, 126 for equal
    lengths, ignores the small band's ceiling).  A property of the
    reference that the port copies; one more unit of cap and both
    escalate and return the distance."""
    rng = random.Random(3)
    a = _rs(rng, 300)
    b = list(a)
    for p in rng.sample(range(300), 130):
        b[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[b[p]]
    b = "".join(b)
    true = oracle.edit_distance(a, b)
    assert 120 <= true <= 126
    jax_engine = _jax_wavefront_engine(monkeypatch)
    for cap, result in ((126, -1), (127, true)):
        got, _ = PairEngine(device="cpu").edit_distances([(a, b)],
                                                         k_cap=[cap])
        want, _ = jax_engine.edit_distances([(a, b)], k_cap=[cap])
        assert int(got[0]) == int(want[0]) == result


def test_long_bucket_route_leaves_narrow_pools_alone(monkeypatch):
    """Pairs in a pool at or below the constant still run the Myers
    windows, and only the wider pools drop their Peq planes."""
    from isocon_tpu_torch.ops import engine as te

    monkeypatch.setattr(te, "MYERS_MAX_L", 256)
    rng = random.Random(2)
    pairs = [(a, _mut(rng, a, 9)) for a in (_rs(rng, 200) for _ in range(6))]
    port = PairEngine(device="cpu")
    got, _ = port.edit_distances(pairs)
    assert port.counters["ed_pairs_wavefront"] == 0
    assert [int(d) for d in got] == [oracle.edit_distance(a, b)
                                     for a, b in pairs]
    wide = _rs(rng, 300)
    got, _ = port.edit_distances([(wide, _mut(rng, wide, 4)), pairs[0]])
    assert port.counters["ed_pairs_wavefront"] == 1
    assert port._get_pool(512).tensors()[2].shape[2] == 0
    assert port._get_pool(256).tensors()[2].shape[2] == 8


def test_true_width_long_reads_match_oracle():
    """17 kb pairs through the unpatched engine: the 32,768-wide pool, the
    banded wavefront at 128 and 256, one pair giving up under its cap."""
    rng = random.Random(5)
    base = _rs(rng, 17000)
    pairs = [(base, _mut(rng, base, 30)), (_mut(rng, base, 70), base),
             (base, base[:9000] + base[9040:]),
             (base, _mut(rng, base, 400))]
    caps = np.array([2 ** 30, 2 ** 30, 2 ** 30, 100])
    port = PairEngine(device="cpu")
    got, gej = port.edit_distances(pairs, k_cap=caps)
    want = [oracle.edit_distance(a, b) for a, b in pairs[:3]] + [-1]
    assert [int(d) for d in got] == want
    assert [int(e) for e in gej[:3]] == [len(b) for _, b in pairs[:3]]
    assert port.counters["ed_pairs_wavefront"] >= 4
    assert port.counters["ed_pairs_full_window"] == 0
    assert sorted(port._pools) == [32768]
    assert "wavefront" in port.stats_line()
