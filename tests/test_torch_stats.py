"""Phase 2's host layers in the port vs the JAX package: the per-edge
statistical tests (``stats/``), the read -> candidate 2-set NN search and
the greedy bipartite assignment.  Inputs are seeded; comparisons are exact:
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
from isocon_tpu_torch.graph.nn import nearest_neighbors_2set
from isocon_tpu_torch.graph.partition import greedy_bipartite_assignment
from isocon_tpu_torch.io.ccs import CCS
from isocon_tpu_torch.ops.engine import PairEngine
from isocon_tpu_torch.params import Params
from isocon_tpu_torch.pipeline.alignments import align_pair_list
from isocon_tpu_torch.stats import raghavan
from isocon_tpu_torch.stats.test import do_statistical_tests_per_edge
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
