"""MAM vote and correction of a round at once (``correct/dense.py::
correct_round``, ``ops/consensus.py``) against the JAX package.

On the CPU the port's ``correct_strings`` runs the plain version of the
consensus chain; it must equal the JAX package's ``correct_strings`` and,
partition by partition, its ``correct_to_consensus_dense`` exactly, on
seeded star partitions.  The chain's kernels are held to the plain
version on the card in ``test_torch_cuda.py`` (a file that imports no JAX,
which the card's machine lacks).
"""
import random

import numpy as np
import pytest
import torch

import chip_smoke
from isocon_tpu.correct.consensus import correct_strings as jax_correct_strings
from isocon_tpu.correct.dense import correct_to_consensus_dense
from isocon_tpu_torch.correct.consensus import correct_strings
from isocon_tpu_torch.correct.dense import build_dense_mam, pack_round
from isocon_tpu_torch.ops import consensus as cons


def _member(center, subs=(), ins=(), dels=()):
    """(s, ed, m_aln, s_aln): ``center`` with substitutions {pos: base},
    insertions {pos: bases} (before the base at pos) and deleted
    positions, as its alignment to the center."""
    subs, ins, dels = dict(subs), dict(ins), set(dels)
    m_aln, s_aln = [], []
    for i, c in enumerate(center):
        if i in ins:
            m_aln.append("-" * len(ins[i]))
            s_aln.append(ins[i])
        m_aln.append(c)
        s_aln.append("-" if i in dels else subs.get(i, c))
    s_aln = "".join(s_aln)
    ed = len(subs) + len(dels) + sum(map(len, ins.values()))
    return s_aln.replace("-", ""), ed, "".join(m_aln), s_aln


def _star(center, members, center_degree=1):
    """{s: (ed, m_aln, s_aln, degree)} from ``_member`` tuples and
    degrees."""
    part = {center: (0, center, center, center_degree)}
    for (s, ed, m_aln, s_aln), deg in members:
        assert s not in part
        part[s] = (ed, m_aln, s_aln, deg)
    return part


def _random_center(rs, L):
    return np.frombuffer(b"ACGT", np.uint8)[rs.integers(0, 4, L)].tobytes() \
        .decode()


def _other(c, k=1):
    return "ACGT"[("ACGT".index(c) + k) % 4]


def case_targeted(rs):
    """A targeted partition: 81 rows of 1.3 kb at 1% noise, a converged
    member in ten, two insertion hotspots."""
    m, part = chip_smoke.star_partition(np, rs, 1300, 81, 0.01,
                                        degrees=(1,) * 9 + (2,), hotspots=2)
    return {m: part}


def case_long(rs):
    """A long partition: 9 rows of the 16,569-base mtDNA at 0.2% noise."""
    m, part = chip_smoke.star_partition(np, rs, 16569, 9, 0.002,
                                        hotspots=20)
    return {m: part}


def case_insertions(rs):
    """Insertion hotspots in a slot in ten: expanded slots whose members'
    insertions differ."""
    m, part = chip_smoke.star_partition(np, rs, 300, 20, 0.02, hotspots=30)
    return {m: part}


def case_ambiguous(rs):
    """Two haplotypes of equal weight: their SNV columns tie."""
    L = 200
    c = _random_center(rs, L)
    snv = {50: _other(c[50]), 120: _other(c[120])}
    members = []
    for k in range(7):
        subs = {10 + 20 * k: _other(c[10 + 20 * k], 2)} if k < 6 else {}
        if k >= 3:                      # 4 rows alt, 4 rows (center) ref
            subs.update(snv)
        members.append((_member(c, subs), 1))
    return {c: _star(c, members)}


def case_converged(rs):
    """Most members converged (degree above 1): never corrected."""
    m, part = chip_smoke.star_partition(np, rs, 400, 16, 0.02,
                                        degrees=(1, 2, 3, 5))
    return {m: part}


def case_ties(rs):
    """Each member has two singleton substitutions: equal freqs, n = 2,
    the cut at the first and extended through the second; the center
    mismatches nowhere."""
    L = 240
    c = _random_center(rs, L)
    members = [(_member(c, {7 + 30 * k: _other(c[7 + 30 * k]),
                            19 + 30 * k: _other(c[19 + 30 * k], 3)}), 1)
               for k in range(7)]
    return {c: _star(c, members)}


def case_all_mismatch(rs):
    """A member that differs from the majority at every base column, beside
    converged members that carry the majority."""
    L = 150
    c = _random_center(rs, L)
    members = [(_member(c, {5 + 40 * k: _other(c[5 + 40 * k])}), 2)
               for k in range(3)]
    members.append((_member(c, {i: _other(ch, 1 + i % 3)
                                for i, ch in enumerate(c)}), 1))
    members.append((_member(c, {}, {60: "GA"}, {90}), 1))
    return {c: _star(c, members, center_degree=2)}


def case_mixed_round(rs):
    """One round of dense partitions and the oracle's: a single member, two
    members of support 2, two of support 3 (dense), a random star."""
    pa = {}
    c = _random_center(rs, 120)
    pa[c] = _star(c, [])
    c = _random_center(rs, 130)
    pa[c] = _star(c, [(_member(c, {3: _other(c[3])}), 1)])
    c = _random_center(rs, 140)
    pa[c] = _star(c, [(_member(c, {8: _other(c[8])}, {20: "T"}), 1)],
                  center_degree=2)
    m, part = chip_smoke.star_partition(np, rs, 500, 12, 0.03, hotspots=5)
    pa[m] = part
    m, part = chip_smoke.star_partition(np, rs, 260, 6, 0.05,
                                        degrees=(1, 1, 2))
    pa[m] = part
    return pa


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _accessions(pa, rs):
    """Each string's accessions: one to three a string."""
    s2a, n = {}, 0
    for part in pa.values():
        for s in part:
            k = int(rs.integers(1, 4))
            s2a[s] = ["r%d" % (n + i) for i in range(k)]
            n += k
    return s2a


def _dense(part):
    return len(part) > 1 and sum(t[3] for t in part.values()) > 2


def _plain_outputs(pa):
    """The plain chain's outputs on the round's dense partitions."""
    parts = [build_dense_mam(m, pa[m]) for m in sorted(pa) if _dense(pa[m])]
    flat, table, deg, rows = (torch.from_numpy(a) for a in pack_round(parts))
    return table, deg, cons.consensus_plain(
        flat, table, deg, rows, cols=int(table[:, 2].sum()),
        width=int(table[:, 2].max()))


def _claim(case, pa, s2a, got):
    """What each case is there to cover, read off the chain's outputs."""
    table, deg, (_c, _m, unamb, _e, _o, _l, nmis) = _plain_outputs(pa)
    L = max(len(m) for m in pa)
    if case in ("targeted", "long"):
        return bool((nmis > 0).any())
    if case == "insertions":
        return bool((table[:, 2] > 2 * L + 1 + 20).all())
    if case == "ambiguous":
        return bool((unamb == 0).any())
    if case == "converged":
        return bool((deg > 1).sum() > len(deg) // 2)
    if case == "ties":     # both substitutions corrected; the center has
        (c, part), = pa.items()          # no mismatch
        return bool((nmis == 0).any()) and all(
            got.get(acc) == c for s in part if s != c for acc in s2a[s])
    if case == "all_mismatch":
        return int(nmis.max()) == L
    return any(not _dense(p) for p in pa.values()) and table.shape[0] == 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_correct_strings_matches_jax(case):
    rs = np.random.default_rng(sorted(CASES).index(case) + 101)
    pa = CASES[case](rs)
    s2a = _accessions(pa, rs)
    got, got_qual = correct_strings(pa, s2a, 1)
    want, want_qual = jax_correct_strings(pa, s2a, 1)
    assert got == want
    assert list(got) == list(want)
    assert got_qual == want_qual == {}
    for m, part in pa.items():
        ps2a = {s: s2a[s] for s in part}
        mine = {acc: got[acc] for s in part for acc in s2a[s] if acc in got}
        if _dense(part):
            assert mine == correct_to_consensus_dense(m, part, ps2a)
        else:
            assert mine == {}
    assert _claim(case, pa, s2a, got)


def test_correct_strings_counts_rows_on_the_engine():
    """An engine's counters: the dense partitions' rows, the others' of
    more than one member, and the MAM bytes uploaded."""
    from isocon_tpu_torch.ops.engine import PairEngine

    rs = np.random.default_rng(5)
    pa = case_mixed_round(rs)
    s2a = _accessions(pa, rs)
    engine = PairEngine(device="cpu")
    got, _ = correct_strings(pa, s2a, 1, engine=engine)
    assert got == correct_strings(pa, s2a, 1)[0]
    c = engine.counters
    assert c["consensus_rows_card"] == sum(len(p) for p in pa.values()
                                           if _dense(p))
    assert c["consensus_rows_host"] == 2
    assert c["upload_bytes"] > sum(2 * len(m) * len(p) for m, p in pa.items()
                                   if _dense(p))
    assert "MAM rows: %d consensus chain, 2 host" % (
        c["consensus_rows_card"]) in engine.stats_line()


def test_random_rounds_match_jax():
    """Many small seeded rounds of random stars (oracle-aligned members)."""
    from isocon_tpu.ops import oracle

    rng = random.Random(11)
    for trial in range(25):
        pa = {}
        for _ in range(rng.randrange(1, 5)):
            c = "".join(rng.choice("ACGT") for _ in range(rng.randrange(30, 110)))
            part = {c: (0, c, c, rng.choice([1, 1, 2]))}
            for _ in range(rng.randrange(0, 8)):
                s = list(c)
                for _ in range(rng.randrange(0, 7)):
                    p = rng.randrange(len(s))
                    op = rng.choice("SSID")
                    if op == "S":
                        s[p] = rng.choice("ACGT")
                    elif op == "I":
                        s.insert(p, rng.choice("ACGT"))
                    elif len(s) > 2:
                        del s[p]
                s = "".join(s)
                if s in part:
                    continue
                a1, a2, (_mat, mis, ind) = oracle.align_semi_global(
                    c, s, 2, -2, 2, 0)
                part[s] = (mis + ind, a1, a2, rng.choice([1, 1, 1, 2, 3]))
            pa[c] = part
        s2a = {}
        for part in pa.values():
            for s in part:
                s2a.setdefault(s, ["a%d" % len(s2a)])
        assert correct_strings(pa, s2a, 1) == jax_correct_strings(pa, s2a, 1), \
            trial
