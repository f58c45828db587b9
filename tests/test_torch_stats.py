"""Phase 2's host layers in the port vs the JAX package: the per-edge
statistical tests (``stats/``) and their alignment store, the read ->
candidate 2-set NN search and the greedy bipartite assignment.  Inputs are seeded; comparisons are exact:
p-values as floats with ``==`` and as their printed strings, dicts with
their key order, and the pair count of every engine call.
"""
import random

import numpy as np
import pytest

from isocon_tpu.graph.nn import nearest_neighbors_2set as jax_nn2
from isocon_tpu.graph.partition import (
    greedy_bipartite_assignment as jax_assign)
from isocon_tpu.io.ccs import CCS as JaxCCS
from isocon_tpu.ops.engine import PairEngine as JaxEngine
from isocon_tpu.params import Params as JaxParams
from isocon_tpu.pipeline.alignments import align_pair_list as jax_align
from isocon_tpu.stats import raghavan as jax_raghavan
from isocon_tpu.stats.test import (
    do_statistical_tests_per_edge as jax_tests)
from isocon_tpu_torch.alnutils import (
    get_mask_start_and_end, read_errors_from_alignment)
from isocon_tpu_torch.graph.nn import nearest_neighbors_2set
from isocon_tpu_torch.graph.partition import greedy_bipartite_assignment
from isocon_tpu_torch.io.ccs import CCS
from isocon_tpu_torch.ops.engine import PairEngine
from isocon_tpu_torch.params import Params
from isocon_tpu_torch.pipeline.alignments import align_pair_list
from isocon_tpu_torch.pipeline.stat_filter import stat_filter_candidates
from isocon_tpu_torch.stats import raghavan
from isocon_tpu_torch.stats import variants as V
from isocon_tpu_torch.stats.store import AlignmentStore
from isocon_tpu_torch.stats.test import (
    _masked_variants, do_statistical_tests_per_edge)
from test_torch_candidates import _recording, noisy_copy, rand_seq
from test_torch_native import plain_port_routes


@pytest.fixture(scope="module", autouse=True)
def _plain_port_routes():
    """The port's engines in this file keep the plain K1/K2/K5 on the CPU
    (``ISOCON_NO_NATIVE=1``); ``tests/test_torch_native.py`` holds the
    host route."""
    with plain_port_routes():
        yield


@pytest.fixture(scope="module")
def case():
    """Four candidates (a base, a 2-SNV, a 1-deletion and a 1-SNV variant
    with almost no reads) and their seeded noisy reads with qualities."""
    rng = random.Random(3)
    base = rand_seq(rng, 260)
    snv2 = list(base)
    for pos in (70, 180):
        snv2[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[snv2[pos]]
    snv1 = list(base)
    snv1[120] = {"A": "C", "C": "G", "G": "T", "T": "A"}[snv1[120]]
    C = {"c_base": base, "c_snv2": "".join(snv2),
         "c_del": base[:100] + base[102:], "c_snv1": "".join(snv1)}
    counts = {"c_base": 14, "c_snv2": 9, "c_del": 6, "c_snv1": 2}
    reads, quals, members = {}, {}, {}
    for c_acc, count in counts.items():
        members[c_acc] = []
        for i in range(count):
            acc = "read_%s_%d" % (c_acc, i)
            reads[acc] = noisy_copy(rng, C[c_acc], 0.02)
            quals[acc] = [rng.randrange(15, 60) for _ in reads[acc]]
            members[c_acc].append(acc)
    graph = {"c_base": {}, "c_snv2": {"c_base": 2},
             "c_del": {"c_base": 2, "c_snv2": 4}, "c_snv1": {"c_base": 1}}
    return C, reads, quals, members, graph


def _partition(case, engine, align):
    C, reads, _q, members, _g = case
    part = {}
    for c_acc, accs in members.items():
        _eds, alns = align(engine, [(C[c_acc], reads[a]) for a in accs])
        part[c_acc] = dict(zip(accs, alns))
    return part


@pytest.mark.parametrize("with_ccs", [False, True])
def test_statistical_tests_per_edge_match(case, with_ccs):
    C, reads, quals, _members, graph = case
    jax_engine, want_calls = _recording(JaxEngine())
    engine, got_calls = _recording(PairEngine(device="cpu"))
    want_part = _partition(case, jax_engine, jax_align)
    got_part = _partition(case, engine, align_pair_list)
    assert got_part == want_part
    ccs_j = ccs_t = {}
    if with_ccs:
        ccs_j = {a: JaxCCS(a, reads[a], quals[a], 10) for a in reads}
        ccs_t = {a: CCS(a, reads[a], quals[a], 10) for a in reads}
    want = jax_tests(graph, C, want_part, ccs_j,
                     JaxParams(p_value_threshold=0.01), jax_engine)
    got = do_statistical_tests_per_edge(
        graph, C, got_part, ccs_t, Params(p_value_threshold=0.01), engine)
    assert got_calls == want_calls
    assert got == want                      # floats compared with ==
    assert list(got) == list(want)
    n_tests = 0
    for c_acc in want:
        assert list(got[c_acc]) == list(want[c_acc])
        for t_acc, (p, factor, k, n_t, variants) in want[c_acc].items():
            gp, gfactor = got[c_acc][t_acc][:2]
            assert (str(gp), str(gfactor)) == (str(p), str(factor))
            assert n_t > 0 and variants
            n_tests += 1
    assert n_tests == 4
    pvals = [v[0] for d in want.values() for v in d.values()]
    assert min(pvals) < 1e-6 < max(pvals)   # significant and not


def test_raghavan_bound_matches():
    rng = random.Random(8)
    for trial in range(30):
        n = rng.randrange(3, 60)
        probs = {"r%d" % i: 10 ** -rng.uniform(0.5, 4) for i in range(n)}
        support = ["r%d" % i for i in range(rng.randrange(0, min(n, 8)))]
        kw = {}
        if trial % 3 == 0:
            kw = dict(threshold=0.01, factor=rng.choice([1.0, 50.0, 1e4]))
        want = jax_raghavan.raghavan_upper_pvalue_bound(probs, support, **kw)
        got = raghavan.raghavan_upper_pvalue_bound(probs, support, **kw)
        assert got == want and str(got) == str(want)
    delta = {5: ("S", "A", 1), 90: ("D", "-", 2)}
    assert (raghavan.correction_factor(300, delta)
            == jax_raghavan.correction_factor(300, delta))


def _two_sets(seed):
    """Reads against candidates: noisy copies of 5 candidate families of
    distinct lengths, a few exact copies (ed 0), and unrelated reads."""
    rng = random.Random(seed)
    targets = {}
    for k in range(5):
        base = rand_seq(rng, 180 + 45 * k)
        targets["cand_%d" % (2 * k)] = base
        alt = list(base)
        for pos in rng.sample(range(len(base)), 3):
            alt[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[alt[pos]]
        targets["cand_%d" % (2 * k + 1)] = "".join(alt)
    t_accs = sorted(targets)
    queries = {}
    for i in range(70):
        src = targets[t_accs[i % len(t_accs)]]
        if i % 10 == 0:
            q = src
        elif i % 10 == 1:
            q = rand_seq(rng, rng.randrange(150, 400))
        else:
            q = noisy_copy(rng, src, rng.choice([0.01, 0.03, 0.08]))
        queries["read_%d" % i] = q
    return queries, targets


@pytest.mark.parametrize("seed,depth", [(1, None), (2, None), (3, 2)])
def test_nearest_neighbors_2set_matches(seed, depth):
    queries, targets = _two_sets(seed)
    jax_engine, want_calls = _recording(JaxEngine())
    engine, got_calls = _recording(PairEngine(device="cpu"))
    want = jax_nn2(queries, targets, jax_engine, depth=depth)
    got = nearest_neighbors_2set(queries, targets, engine, depth=depth)
    assert got == want
    assert list(got) == list(want)
    for q_acc in want:
        assert list(got[q_acc].items()) == list(want[q_acc].items())
    assert got_calls == want_calls          # pair count of every ED call
    assert len(want_calls) >= 2
    assert any(0 in nn.values() for nn in want.values())
    assert sum(1 for nn in want.values() if nn) >= 50


@pytest.mark.parametrize("seed", [1, 2])
def test_greedy_bipartite_assignment_matches(seed):
    queries, targets = _two_sets(seed)
    nn2 = jax_nn2(queries, targets, JaxEngine())
    edges = {r: list(cs) for r, cs in nn2.items()}
    cands = sorted({c for cs in nn2.values() for c in cs})
    want = jax_assign(edges, cands)
    got = greedy_bipartite_assignment(edges, cands)
    assert got == want
    assert list(got) == list(want)
    for c_acc in want:
        assert list(got[c_acc]) == list(want[c_acc])
    assert sum(len(v) for v in want.values()) >= 50


# -- the alignment store (``stats/store.py``) and the per-edge steps that
# read it, against the per-read Python loops they replaced, kept here as
# plain oracles

def _coord_map_oracle(aln):
    return np.flatnonzero(np.frombuffer(aln.encode("latin1"), np.uint8)
                          != ord("-"))


def _support_oracle(read_alignments_to_c, variant_coords_c,
                    read_alignments_to_t, variant_coords_t,
                    alignment_c_to_t):
    support_c = []
    for read_acc, (aln_c, aln_read, _st) in read_alignments_to_c.items():
        cmap = _coord_map_oracle(aln_c)
        ok = True
        for i, (_v_type, _v_nucl, u_v) in variant_coords_c.items():
            p = cmap[i]
            if (aln_read[max(0, p - 1): p + u_v + 1]
                    != aln_c[max(0, p - 1): p + u_v + 1]):
                ok = False
                break
        if ok:
            support_c.append(read_acc)
    support_from_t = []
    for read_acc, (aln_t, aln_read, _st) in read_alignments_to_t.items():
        tmap = _coord_map_oracle(aln_t)
        ok = True
        for i, (v_type, _v_nucl, u_v) in variant_coords_t.items():
            p = tmap[i]
            snippet = alignment_c_to_t[i]
            if v_type == "I":
                match = aln_read[max(0, p - 2): p + u_v] == snippet
            else:
                match = aln_read[max(0, p - 1): p + u_v + 1] == snippet
            if not match:
                ok = False
                break
        if ok:
            support_from_t.append(read_acc)
    return support_c + support_from_t


def _masked_variants_oracle(aln_t, aln_c):
    start, end = get_mask_start_and_end(aln_t, aln_c)
    return [(i, p_t, p_c) for i, (p_t, p_c) in enumerate(zip(aln_t, aln_c))
            if p_t != p_c and start <= i < end]


def _empirical_oracle(segment_length, errors, variant_coords_t):
    probability = {}
    delta_size = float(len(variant_coords_t))
    for read_acc, (insertions, deletions, substitutions) in errors.items():
        prob = 1.0
        p_S = (max(substitutions, delta_size) / float(segment_length)) / 3.0
        p_I = (max(insertions, delta_size) / float(segment_length)) / 4.0
        p_D = max(deletions, delta_size) / float(segment_length)
        for _i, (v_type, _v_nucl, u_v) in variant_coords_t.items():
            if v_type == "S":
                prob *= p_S * u_v
            elif v_type == "I":
                prob *= min(0.5, p_I * u_v)
            elif v_type == "D":
                prob *= min(0.5, p_D * u_v)
        if prob >= 1.0:
            prob = 0.99999
        probability[read_acc] = prob
    return probability


def _gapped_pair(rng, ref, rate=0.05, lead=(0, 0), trail=(0, 0)):
    """An alignment tuple of a noisy copy of ``ref`` to ``ref``; no column
    is a gap in both rows.  ``lead`` / ``trail``: end gap runs of the
    (reference, read) row: the read overhangs the reference, or starts or
    ends inside it."""
    cols = []
    for ch in ref:
        x = rng.random()
        if x < rate / 3:
            cols.append((ch, "-"))
        elif x < 2 * rate / 3:
            cols += [("-", rng.choice("ACGT")), (ch, ch)]
        elif x < rate:
            cols.append((ch, rng.choice("ACGT")))
        else:
            cols.append((ch, ch))
    head = [("-", rng.choice("ACGT")) for _ in range(lead[0])]
    tail = [("-", rng.choice("ACGT")) for _ in range(trail[0])]
    cols = [(a, "-") if k < lead[1] and a != "-" else (a, b)
            for k, (a, b) in enumerate(cols)]
    n = len(cols)
    cols = [(a, "-") if k >= n - trail[1] and a != "-" else (a, b)
            for k, (a, b) in enumerate(cols)]
    cols = [c for c in head + cols + tail if c != ("-", "-")]
    return ("".join(a for a, _b in cols), "".join(b for _a, b in cols),
            (0, 0, 0))


def _ragged_alignments(rng):
    """Rows of 1 to 16,600 columns: end gaps on either side or both, an
    all-gap read row, an all-gap reference row, a row of one column."""
    alns = [_gapped_pair(rng, rand_seq(rng, rng.randrange(20, 400)),
                         lead=(rng.choice([0, 0, 3]), rng.choice([0, 0, 5])),
                         trail=(rng.choice([0, 0, 4]), rng.choice([0, 0, 2])))
            for _ in range(40)]
    alns.append(_gapped_pair(rng, rand_seq(rng, 16600), 0.002,
                             lead=(0, 7), trail=(9, 0)))
    alns.append(("ACGTTGCA", "--------", (0, 0, 0)))
    alns.append(("--------", "ACGTTGCA", (0, 0, 0)))
    alns.append(("A", "C", (0, 0, 1)))
    alns.append(("AC--", "--GT", (0, 0, 0)))
    rng.shuffle(alns)
    return alns


def _assert_rows_equal(store, alns):
    rows = store.rows({k: a for k, a in enumerate(alns)})
    for aln, row in zip(alns, rows):
        assert (tuple(store.errors[row].tolist())
                == read_errors_from_alignment(aln[0], aln[1]))
        assert np.array_equal(store.coord_map(row), _coord_map_oracle(aln[0]))
        s, n = store.start[row], store.length[row]
        assert store.ref[s:s + n].tobytes().decode("latin1") == aln[0]
        assert store.read[s:s + n].tobytes().decode("latin1") == aln[1]


def test_store_rows_match_the_scalar_helpers():
    rng = random.Random(21)
    alns = _ragged_alignments(rng)
    store = AlignmentStore()
    store.add(alns[:10])
    store.add(alns)                         # the first ten are not redone
    assert store.counters["stat_rows_built"] == len(alns)
    _assert_rows_equal(store, alns)
    assert store.counters["stat_rows_used"] == len(alns)
    # dropping most rows compacts the buffers; the rest read the same
    kept = alns[::4]
    store.retain({"c": {k: a for k, a in enumerate(kept)}})
    assert len(store._held) == len(kept)
    assert store.ref.size == sum(len(a[0]) for a in kept)
    _assert_rows_equal(store, kept)
    with pytest.raises(KeyError):
        store.rows({"gone": alns[1]})


def test_store_converts_a_reassigned_read_again():
    rng = random.Random(22)
    cand_a, cand_b = rand_seq(rng, 300), rand_seq(rng, 280)
    old = _gapped_pair(rng, cand_a, 0.05)
    same = tuple(old)                       # equal, but another object
    assert same == old
    store = AlignmentStore()
    part = {"a": {"r": old, "s": _gapped_pair(rng, cand_a)}, "b": {}}
    store.add(part["a"].values())
    assert store.counters["stat_rows_built"] == 2
    new = _gapped_pair(rng, cand_b, 0.08, lead=(0, 2))
    part = {"a": {"s": part["a"]["s"]}, "b": {"r": new}}
    store.retain(part)
    store.add([part["a"]["s"], new])
    assert store.counters["stat_rows_built"] == 3
    _assert_rows_equal(store, [new, part["a"]["s"]])
    assert (tuple(store.errors[store.rows(part["b"])[0]].tolist())
            == read_errors_from_alignment(new[0], new[1])
            != read_errors_from_alignment(old[0], old[1]))
    store.add([same])                       # a new tuple is converted anew
    assert store.counters["stat_rows_built"] == 4


def _edge_case(seed):
    """Reads of c and of t with their alignments, and variants of every
    type at column 0, at the last position and between; t's snippets are
    taken from some of t's reads, so both outcomes occur."""
    rng = random.Random(seed)
    c_seq, t_seq = rand_seq(rng, 120), rand_seq(rng, 118)
    to_c = {"c%d" % k: _gapped_pair(rng, c_seq, rng.choice([0.0, 0.01, 0.06]),
                                    trail=(0, rng.choice([0, 3])))
            for k in range(rng.randrange(0, 14))}
    to_t = {"t%d" % k: _gapped_pair(rng, t_seq, rng.choice([0.0, 0.01, 0.06]),
                                    lead=(0, rng.choice([0, 2])))
            for k in range(rng.randrange(1, 14))}
    types = "SID"
    pos_c = sorted({0, len(c_seq) - 1, *rng.sample(range(len(c_seq)), 3)})
    pos_t = sorted({0, len(t_seq) - 1, *rng.sample(range(len(t_seq)), 3)})
    vc = {i: (rng.choice(types), "A", rng.choice([1, 1, 2, 3]))
          for i in pos_c}
    vt = {i: (rng.choice(types), "A", rng.choice([1, 1, 2, 4]))
          for i in pos_t}
    c2t = {}
    donors = list(to_t.values())
    for i, (v_type, _n, u_v) in vt.items():
        aln_t, aln_read, _st = rng.choice(donors)
        p = int(_coord_map_oracle(aln_t)[i])
        if v_type == "I":
            c2t[i] = aln_read[max(0, p - 2): p + u_v]
        else:
            c2t[i] = aln_read[max(0, p - 1): p + u_v + 1]
        if rng.random() < 0.3:
            c2t[i] = rand_seq(rng, rng.randrange(1, 6))
    if rng.random() < 0.3:
        vc = {}
    return to_c, vc, to_t, vt, c2t


@pytest.mark.parametrize("seed", range(12))
def test_get_support_matches_the_python_loop(seed):
    to_c, vc, to_t, vt, c2t = _edge_case(seed)
    store = AlignmentStore()
    store.add(list(to_c.values()) + list(to_t.values()))
    got = V.get_support(store, to_c, store.rows(to_c), vc, to_t,
                        store.rows(to_t), vt, c2t)
    want = _support_oracle(to_c, vc, to_t, vt, c2t)
    assert got == want
    if seed < 3:
        assert want and len(want) < len(to_c) + len(to_t)


@pytest.mark.parametrize("seed", range(6))
def test_empirical_probabilities_match_the_scalar_loop(seed):
    to_c, _vc, to_t, vt, _c2t = _edge_case(seed)
    store = AlignmentStore()
    store.add(list(to_c.values()) + list(to_t.values()))
    rows_c, rows_t = store.rows(to_c), store.rows(to_t)
    errors = V.get_read_errors(store, to_c, rows_c, to_t, rows_t)
    want_errors = {acc: read_errors_from_alignment(a, b)
                   for acc, (a, b, _st) in list(to_t.items())
                   + list(to_c.items())}
    assert errors == want_errors and list(errors) == list(want_errors)
    want = _empirical_oracle(118, errors, vt)
    got = V.get_empirical_error_probabilities(
        118, list(errors), store.errors[np.concatenate([rows_t, rows_c])], vt)
    assert list(got) == list(want)
    assert all(type(v) is float for v in got.values())
    assert got == want                      # floats compared with ==


@pytest.mark.parametrize("seed", range(8))
def test_masked_variants_match_the_python_loop(seed):
    rng = random.Random(100 + seed)
    base = rand_seq(rng, rng.randrange(30, 200))
    other = list(base)
    for pos in {0, len(base) - 1, *rng.sample(range(len(base)), 4)}:
        other[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[other[pos]]
    aln = _gapped_pair(rng, "".join(other), 0.04,
                       lead=rng.choice([(0, 0), (0, 3), (2, 0)]),
                       trail=rng.choice([(0, 0), (0, 2), (4, 0)]))
    got = _masked_variants(aln[0], aln[1])
    assert got == _masked_variants_oracle(aln[0], aln[1])
    assert got == [(int(i), a, b) for i, a, b in got]


def _moved(case, engine, part):
    """``part`` after c_snv1 is removed and its reads realigned to c_base:
    new tuples beside the unmoved reads' old ones."""
    C, reads, _q, members, _g = case
    moved = members["c_snv1"]
    _eds, alns = align_pair_list(engine, [(C["c_base"], reads[a])
                                          for a in moved])
    part2 = {c: dict(p) for c, p in part.items() if c != "c_snv1"}
    part2["c_base"].update(zip(moved, alns))
    C2 = {c: s for c, s in C.items() if c != "c_snv1"}
    graph2 = {"c_base": {}, "c_snv2": {"c_base": 2},
              "c_del": {"c_base": 2, "c_snv2": 4}}
    return C2, part2, graph2


@pytest.mark.parametrize("with_ccs", [False, True])
def test_statistical_tests_share_one_store(case, with_ccs):
    """Two rounds, the second after a candidate's reads were reassigned:
    through one store, through a store each call, and the JAX package's,
    equal value for value and in order."""
    C, reads, quals, _members, graph = case
    engine = PairEngine(device="cpu")
    jax_engine = JaxEngine()
    part = _partition(case, engine, align_pair_list)
    want_part = _partition(case, jax_engine, jax_align)
    C2, part2, graph2 = _moved(case, engine, part)
    want_C2, want_part2, _g = _moved(case, jax_engine, want_part)
    assert (part, part2) == (want_part, want_part2)
    ccs_j = ccs_t = {}
    if with_ccs:
        ccs_j = {a: JaxCCS(a, reads[a], quals[a], 10) for a in reads}
        ccs_t = {a: CCS(a, reads[a], quals[a], 10) for a in reads}
    params, jax_params = (Params(p_value_threshold=0.01),
                          JaxParams(p_value_threshold=0.01))
    store = AlignmentStore(engine.counters)
    got, alone, want = [], [], []
    for g, c, p, wp in ((graph, C, part, want_part),
                        (graph2, C2, part2, want_part2)):
        got.append(do_statistical_tests_per_edge(g, c, p, ccs_t, params,
                                                 engine, store))
        alone.append(do_statistical_tests_per_edge(g, c, p, ccs_t, params,
                                                   PairEngine(device="cpu")))
        want.append(jax_tests(g, dict(c), wp, ccs_j, jax_params, jax_engine))
    for g, a, w in zip(got, alone, want):
        assert g == a == w                  # floats compared with ==
        assert list(g) == list(a) == list(w)
        for c_acc in w:
            assert list(g[c_acc]) == list(a[c_acc]) == list(w[c_acc])
    n_reads = sum(len(v) for v in part.values())
    moved = len(part2["c_base"]) - len(part["c_base"])
    built = engine.counters["stat_rows_built"]
    assert built == n_reads + moved         # the moved reads once more
    assert len(store._row) == n_reads       # c_snv1's old rows dropped
    assert moved > 0 and built < engine.counters["stat_rows_used"]


def test_stat_filter_counts_the_store_rows(case, tmp_path):
    C, reads, _q, _members, _g = case
    engine = PairEngine(device="cpu")
    assert engine.counters["stat_rows_built"] == 0
    assert engine.counters["stat_rows_used"] == 0
    read_file, cand_file = tmp_path / "reads.fa", tmp_path / "cands.fa"
    read_file.write_text("".join(">%s\n%s\n" % kv for kv in reads.items()))
    cand_file.write_text("".join(">%s\n%s\n" % kv for kv in C.items()))
    part = _partition(case, engine, align_pair_list)
    params = Params(outfolder=str(tmp_path), p_value_threshold=0.01)
    stat_filter_candidates(str(read_file), str(cand_file), part, {}, params,
                           engine)
    built = engine.counters["stat_rows_built"]
    used = engine.counters["stat_rows_used"]
    assert 0 < built <= used
    assert "test rows: %d built, %d used" % (built, used) in (
        engine.stats_line())
