"""Ends-invariant candidate machinery.

Two capabilities from ``end_invariant_functions.py``:

1. ``collapse_candidates_under_ends_invariant`` (``:975-1063``): candidates
   identical except for <= ignore_ends_len bp at the ends are merged.  Edges
   come from pure string checks -- strict substring within end offsets
   (``:936-943``) or perfect prefix/suffix overlap within the threshold
   (``is_overlap``, ``:884-917``) -- then the standard star partition with
   the "ends" tie-break collapses each group to one representative.

2. ``ends_ignored_nn_graph`` (= ``get_NN_graph_ignored_ends_edlib``,
   ``:757-788``): the static all-neighbors candidate graph used by phase 2.
   Distance = edlib HW (infix) distance of c1 in c2, with target-flank
   overhang beyond the threshold charged and query-end insertion runs
   forgiven up to the threshold (``edlib_traceback``, ``:593-621``);
   symmetrized by min; edges kept when the adjusted distance <=
   max_variants (10).
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Set, Tuple

import numpy as np

from ..native import hw_traceback_batch
from .partition import star_partition

MAX_VARIANTS = 10


def is_overlap(text1: str, text2: str, ignore_ends_threshold: int) -> bool:
    """True if a suffix of text1 equals a prefix of text2 and the unmatched
    flanks are both within the threshold (``:884-917``)."""
    n1, n2 = len(text1), len(text2)
    if n1 == 0 or n2 == 0:
        return False
    t1, t2 = text1, text2
    if n1 > n2:
        t1 = text1[-n2:]
    elif n1 < n2:
        t2 = text2[:n1]
    if t1 == t2:
        return True  # reference returns the overlap length (truthy)
    best = 0
    length = 1
    while True:
        pattern = t1[-length:]
        found = t2.find(pattern)
        if found == -1:
            prefix_offset = n1 - best
            suffix_offset = n2 - best
            return (
                prefix_offset <= ignore_ends_threshold
                and suffix_offset <= ignore_ends_threshold
            )
        length += found
        if t1[-length:] == t2[:length]:
            best = length
            length += 1


def invariant_edges(
    candidates: Dict[str, str], threshold: int
):
    """Symmetric edges between end-invariant candidates
    (``get_invariants_under_ignored_edge_ends_speed``, ``:920-954``)."""
    edges = set()
    ordered = sorted(candidates.items(), key=lambda x: len(x[1]))
    for i, (acc1, seq1) in enumerate(ordered):
        for acc2, seq2 in ordered:
            if acc2 == acc1:
                continue
            if len(seq2) < len(seq1) - 2 * threshold:
                continue
            if len(seq1) - 2 * threshold <= len(seq2) <= len(seq1):
                if seq2 in seq1:
                    start_offset = seq1.find(seq2)
                    end_offset = len(seq1) - (start_offset + len(seq2))
                    if start_offset <= threshold and end_offset <= threshold:
                        edges.add((acc2, acc1))
                        edges.add((acc1, acc2))
                elif is_overlap(seq1, seq2, threshold) or is_overlap(
                    seq2, seq1, threshold
                ):
                    edges.add((acc2, acc1))
                    edges.add((acc1, acc2))
            else:
                break
    return edges


def collapse_candidates_under_ends_invariant(
    candidates: Dict[str, str],
    support: Dict[str, int],
    ignore_ends_len: int,
    verbose: bool = False,
) -> Dict[str, Set[str]]:
    """{kept_acc: set(collapsed-away accs)} (``:975-1063``)."""
    accs = sorted(candidates)
    idx = {a: i for i, a in enumerate(accs)}
    edges = [
        (idx[a], idx[b])
        for a, b in invariant_edges(candidates, ignore_ends_len)
    ]
    degrees = [support[a] for a in accs]
    _M, part = star_partition(accs, degrees, edges, tiebreak="ends")
    return {accs[c]: {accs[m] for m in members} for c, members in part.items()}


def _adjust_hw_distance(
    ed: int, ops: str, start_j: int, end_j_incl: int, t_len: int, end_threshold: int
) -> int:
    """The reference's end adjustments on the HW cigar (``:593-621``):
    charge target overhang beyond the threshold, forgive query-end
    insertion runs up to it."""
    start_offset = start_j
    end_offset = t_len - (end_j_incl + 1)
    ed += max(0, start_offset - end_threshold)
    ed += max(0, end_offset - end_threshold)
    m = re.match(r"I+", ops)
    if m:
        ed -= min(len(m.group()), end_threshold)
    m = re.match(r"I+", ops[::-1])
    if m:
        ed -= min(len(m.group()), end_threshold)
    return ed


def static_graph_pairs(
    candidates: Dict[str, str], ignore_ends_len: int,
    neighbor_search_depth: int | None = None,
) -> Tuple[List[Tuple[str, str]], List[Tuple[int, int]]]:
    """The static graph's candidates and pairs (``:650-657``, ``:757-762``):
    ``ordered``, the (seq, acc) of every candidate sorted by length (stable,
    in the dict's order), and the directed pairs (i, j) of positions in it,
    in the order the reference computes them: for each i, its neighbours
    i - 1, i + 1, i - 2, ... while either side's length lies within
    max_variants + 2 * ignore_ends_len of len i (and for at most
    ``neighbor_search_depth`` steps).  Query i, target j: the static
    graph's K2 launches take runs of pairs that share a query."""
    window = MAX_VARIANTS + 2 * ignore_ends_len
    ordered = sorted(
        ((seq, acc) for acc, seq in candidates.items()), key=lambda x: len(x[0])
    )
    lens = [len(s) for s, _ in ordered]
    n = len(ordered)
    wanted = []
    for i in range(n):
        j = 1
        steps = 0
        while True:
            lo_ok = i - j >= 0 and abs(lens[i] - lens[i - j]) <= window
            hi_ok = i + j < n and abs(lens[i] - lens[i + j]) <= window
            if lo_ok:
                wanted.append((i, i - j))
            if hi_ok:
                wanted.append((i, i + j))
            if not lo_ok and not hi_ok:
                if (i - j < 0 or abs(lens[i] - lens[i - j]) > window) and (
                    i + j >= n or abs(lens[i] - lens[i + j]) > window
                ):
                    break
            steps += 1
            if neighbor_search_depth is not None and steps >= neighbor_search_depth:
                break
            j += 1
    return ordered, wanted


def ends_ignored_nn_graph(
    candidates: Dict[str, str], ignore_ends_len: int, engine,
    neighbor_search_depth: int | None = None,
) -> Dict[str, Dict[str, int]]:
    """Static all-NN candidate graph under ignored ends (``:757-788``).

    Window: length-sorted neighbors with |len diff| <= max_variants +
    2*ignore_ends_len (``:650-657``, ``static_graph_pairs``); per pair an
    HW alignment of the shorter-ordered pair (query seq1 vs target seq2 in
    both directions as encountered), adjusted for ends; edge kept if
    adjusted ed in [0, max_variants]; graph symmetrized with min
    (``:763-770``).
    """
    max_ed_allowed = MAX_VARIANTS + ignore_ends_len
    ordered, wanted = static_graph_pairs(candidates, ignore_ends_len,
                                         neighbor_search_depth)
    graph: Dict[str, Dict[str, int]] = {acc: {} for acc in candidates}

    # distance pass: batched HW kernel (K2) with cutoff; the pairs under
    # the cutoff then get a host traceback for the end adjustments
    survivors = []
    hints = []
    if wanted:
        ids = engine.add_seqs([s for s, _ in ordered])
        w = np.asarray(wanted, dtype=np.int64)
        eds, _ej = engine.edit_distances_idx(
            ids[w[:, 0]], ids[w[:, 1]],
            k_cap=np.full(len(wanted), max_ed_allowed, dtype=np.int64),
            hw_mode=True,
        )
        survivors = [ij for ij, d in zip(wanted, eds)
                     if 0 <= d <= max_ed_allowed]
        hints = [int(d) for d in eds if 0 <= d <= max_ed_allowed]

    # batched threaded confirm pass (internal band escalation in C++):
    # replaces the per-survivor serial host loop that dominated the static
    # graph build at 10k-candidate scale.  The prefilter's distances seed
    # per-pair bands (band = 2*ed certifies immediately, ~5x less DP).
    t0 = time.perf_counter()
    results = hw_traceback_batch(
        [(ordered[i][0], ordered[j][0]) for i, j in survivors],
        ed_hint=hints)
    engine.counters["hw_survivors"] += len(survivors)
    engine.counters["hw_traceback_seconds"] += time.perf_counter() - t0
    for (i, j), res in zip(survivors, results):
        q_seq, q_acc = ordered[i]
        t_seq, t_acc = ordered[j]
        ed, start_j, end_j, ops = res
        if ed > max_ed_allowed:
            continue
        adj = _adjust_hw_distance(ed, ops, start_j, end_j, len(t_seq),
                                  ignore_ends_len)
        if 0 <= adj <= MAX_VARIANTS:
            graph[q_acc][t_acc] = adj

    # symmetrize with min (``:763-770``)
    for c1 in list(graph):
        for c2, ed in list(graph[c1].items()):
            if c1 not in graph[c2]:
                graph[c2][c1] = ed
            else:
                m = min(graph[c1][c2], graph[c2][c1])
                graph[c2][c1] = m
    return graph
