"""Per-edge candidate-vs-reference hypothesis tests.

Re-implements ``hypothesis_test_module.py:20-242``: for each test edge
(c, t), align c and t both ways with the test-phase scoring (match 2,
mismatch -3, open 3, ext 1), keep the direction with fewer masked variants,
extract variant coordinates, count read support, build per-read error
probabilities (quality-based when CCS info exists, else empirical), and
bound the p-value with the Raghavan inequality.

The c<->t alignments for all edges of a round are batched through the
engine in one go (the reference does two parasail calls inside each pooled
worker, ``:99-110``).  The reads' alignments are read through an
``AlignmentStore`` (``store.py``), which converts each into arrays once for
all the edges, and all the rounds, that read it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..alnutils import get_mask_start_and_end
from . import variants as V
from .raghavan import correction_factor, raghavan_upper_pvalue_bound
from .store import AlignmentStore

TEST_SCORES = (2, -3, 3, 1)  # match, mismatch, open, ext (:99,:103)


def _masked_variants(aln_t: str, aln_c: str):
    """(column, t's letter, c's letter) of each column where the rows
    differ, end gap runs masked."""
    start, end = get_mask_start_and_end(aln_t, aln_c)
    row_t = np.frombuffer(aln_t.encode("latin1"), np.uint8)[start:end]
    row_c = np.frombuffer(aln_c.encode("latin1"), np.uint8)[start:end]
    return [(i, aln_t[i], aln_c[i])
            for i in (np.flatnonzero(row_t != row_c) + start).tolist()]


def arrange_and_test(
    t_acc: str,
    c_acc: str,
    t_seq: str,
    c_seq: str,
    read_alignments_to_c: Dict[str, tuple],
    read_alignments_to_t: Dict[str, tuple],
    aln_tc: Tuple[str, str],
    aln_ct: Tuple[str, str],
    ccs_dict,
    max_phred_q_trusted: int,
    p_value_threshold: Optional[float],
    store: AlignmentStore,
):
    """Core of ``arrange_alignments_new_no_realign`` (``:91-174``) given the
    two precomputed alignments: aln_tc = align(t, c), aln_ct = align(c, t),
    and ``store`` holding every read alignment of both dicts.

    Returns (variant_coords_t, p_value, reads_support, nr_reads_used).
    """
    aln_t, aln_c = aln_tc
    variants = _masked_variants(aln_t, aln_c)
    aln_c_flip, aln_t_flip = aln_ct
    variants_flipped = _masked_variants(aln_t_flip, aln_c_flip)
    if len(variants_flipped) < len(variants):
        variants = variants_flipped
        aln_t, aln_c = aln_t_flip, aln_c_flip

    coords = V.get_variant_coordinates(t_seq, c_seq, aln_t, aln_c, variants)
    variant_coords_t, variant_coords_c, alignment_c_to_t, alignment_t_to_c = coords

    rows_c = store.rows(read_alignments_to_c)
    rows_t = store.rows(read_alignments_to_t)
    reads_support = V.get_support(
        store, read_alignments_to_c, rows_c, variant_coords_c,
        read_alignments_to_t, rows_t, variant_coords_t, alignment_c_to_t,
    )

    if len(variants) == 0:
        return (
            variant_coords_t, 0.0, reads_support,
            len(read_alignments_to_c) + len(read_alignments_to_t),
        )

    if ccs_dict:
        errors = V.get_read_errors(store, read_alignments_to_c, rows_c,
                                   read_alignments_to_t, rows_t)
        prob_c, _ns_c = V.get_read_ccs_probabilities_c(
            store, read_alignments_to_c, rows_c, variant_coords_c,
            alignment_t_to_c, ccs_dict, errors, max_phred_q_trusted,
        )
        prob_t, _ns_t = V.get_read_ccs_probabilities_t(
            store, read_alignments_to_t, rows_t, variant_coords_t,
            alignment_c_to_t, ccs_dict, errors, max_phred_q_trusted,
        )
        probability = dict(prob_c)
        probability.update(prob_t)
    else:
        probability = V.get_empirical_error_probabilities(
            len(t_seq),
            list(read_alignments_to_t) + list(read_alignments_to_c),
            store.errors[np.concatenate([rows_t, rows_c])],
            variant_coords_t,
        )

    if len(probability) == 0:
        assert len(reads_support) == 0
        return variant_coords_t, 0.0, reads_support, 0
    # the caller compares p * correction_factor against the threshold, so
    # the near-threshold Decimal re-check needs the factor too
    factor = (
        1.0 if ccs_dict else correction_factor(len(t_seq), variant_coords_t)
    )
    p_value = raghavan_upper_pvalue_bound(
        probability, reads_support, threshold=p_value_threshold, factor=factor
    )
    return variant_coords_t, p_value, reads_support, len(probability)


def statistical_test(
    c_acc, t_acc, c_seq, t_seq, read_alignments_to_c, read_alignments_to_t,
    aln_tc, aln_ct, ccs_dict, max_phred_q_trusted, p_value_threshold,
    store,
):
    """``hypothesis_test_module.py:216-242``.  ``store``: an
    ``AlignmentStore`` holding the reads' alignments.

    Returns (c_acc, t_acc, p_value, correction_factor, k, N_t, variants_str).
    """
    reads = set(read_alignments_to_c) | set(read_alignments_to_t)
    assert not (set(read_alignments_to_c) & set(read_alignments_to_t))
    N_t = len(reads)
    if N_t == 0:
        return c_acc, t_acc, 1.0, 1.0, 0, N_t, ""

    delta_t, p_value, reads_support, nr_used = arrange_and_test(
        t_acc, c_acc, t_seq, c_seq, read_alignments_to_c,
        read_alignments_to_t, aln_tc, aln_ct, ccs_dict, max_phred_q_trusted,
        p_value_threshold, store,
    )
    variant_types = ";".join(
        "(" + str(delta_t[j][0]) + "," + str(j) + "," + str(delta_t[j][2]) + ")"
        for j in delta_t
    )
    if ccs_dict:
        return (c_acc, t_acc, p_value, 1.0, len(reads_support), nr_used,
                variant_types)
    factor = correction_factor(len(t_seq), delta_t)
    return (c_acc, t_acc, p_value, factor, len(reads_support), nr_used,
            variant_types)


def do_statistical_tests_per_edge(
    nearest_neighbor_graph: Dict[str, Dict[str, int]],
    C: Dict[str, str],
    read_partition: Dict[str, Dict[str, tuple]],
    ccs_dict,
    params,
    engine,
    store: Optional[AlignmentStore] = None,
) -> Dict[str, Dict[str, tuple]]:
    """Batch all (c, t) edges of this round (``:20-76``).  ``store``: the
    phase's ``AlignmentStore``, which keeps the reads' alignments across
    rounds (one for this call alone, counting into the engine's counters,
    when not given)."""
    if store is None:
        store = AlignmentStore(engine.counters)
    edges = [
        (c_acc, t_acc)
        for c_acc in nearest_neighbor_graph
        for t_acc in nearest_neighbor_graph[c_acc]
    ]
    store.retain(read_partition)
    tested = dict.fromkeys(acc for edge in edges for acc in edge)
    store.add(aln for acc in tested for aln in read_partition[acc].values())
    # batched both-direction alignments
    pairs = []
    for c_acc, t_acc in edges:
        pairs.append((C[t_acc], C[c_acc]))
        pairs.append((C[c_acc], C[t_acc]))
    scores = [TEST_SCORES] * len(pairs)
    alns = engine.align_pairs(pairs, scores)

    p_values: Dict[str, Dict[str, tuple]] = {
        c_acc: {} for c_acc in nearest_neighbor_graph
    }
    for idx, (c_acc, t_acc) in enumerate(edges):
        a_t, a_c, _st = alns[2 * idx]
        b_c, b_t, _st2 = alns[2 * idx + 1]
        if ccs_dict:
            reduced = {
                x_acc: ccs_dict[x_acc]
                for x_acc in list(read_partition[c_acc]) + list(read_partition[t_acc])
                if x_acc in ccs_dict
            }
        else:
            reduced = {}
        (c_acc_, t_acc_, p_value, factor, k, N_t, variant_types) = statistical_test(
            c_acc, t_acc, C[c_acc], C[t_acc],
            read_partition[c_acc], read_partition[t_acc],
            (a_t, a_c), (b_c, b_t), reduced, params.max_phred_q_trusted,
            getattr(params, "p_value_threshold", None), store,
        )
        p_values[c_acc][t_acc] = (p_value, factor, k, N_t, variant_types)
    return p_values
