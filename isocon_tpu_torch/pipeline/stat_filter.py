"""Phase 2: statistical filtering of candidates.

Re-implements ``isocon_statistical_test.py:149-536``: a fixed-point loop
that (re)assigns reads to candidates, tests every candidate against its
nearest surviving higher-context neighbor with the Raghavan bound, removes
insignificant candidates (queueing their reads for realignment), runs one
forced global realignment to escape local optima, and finally collapses
end-invariant candidates.

Its steps are spans of a profiler trace: ``isocon_phase2.static_graph``
(the candidate graph, once), and in a round ``.assign`` (the 2-set NN
search, the assignment and the realignments) and ``.tests`` (the
statistical tests), each entered once a round that runs it.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, Set

from torch.profiler import record_function

from ..alnutils import filter_exon_differences
from ..graph.end_invariant import (
    collapse_candidates_under_ends_invariant,
    ends_ignored_nn_graph,
)
from ..graph.nn import nearest_neighbors_2set
from ..graph.partition import greedy_bipartite_assignment
from ..io import read_fasta, read_fastx
from ..io.ccs import CCS, ccs_dict_from_bam, ccs_dict_from_fastq
from ..io.output import devlog, logger, print_candidates
from ..stats.store import AlignmentStore
from ..stats.test import do_statistical_tests_per_edge
from .alignments import align_pair_list


def product_with_check_overflow(p_value, mult_factor_inv):
    """``isocon_statistical_test.py:141-147``."""
    try:
        return p_value * mult_factor_inv
    except OverflowError:
        return 1.0


def homopolymer_compress(read: str) -> str:
    out = []
    prev = ""
    for n in read:
        if n != prev:
            out.append(n)
        prev = n
    return "".join(out)


def get_homopolymer_invariants(candidates: Dict[str, str]) -> Dict[str, Dict[str, int]]:
    """Edges between candidates identical after homopolymer compression
    (``functions.py:63-86``)."""
    clusters: Dict[str, list] = {}
    for acc, seq in candidates.items():
        clusters.setdefault(homopolymer_compress(seq), []).append(acc)
    edges: Dict[str, Dict[str, int]] = {}
    for group in clusters.values():
        if len(group) > 1:
            for a in group:
                edges.setdefault(a, {})
            for a in group:
                for b in group:
                    if a != b:
                        edges[a][b] = 1
    return edges


def stat_filter_candidates(read_file, candidate_file, read_partition,
                           to_realign, params, engine):
    """Returns the final candidate dict; writes final_candidates.fa and
    cluster_info.tsv."""
    if params.is_fastq:
        X_original = {acc: seq for acc, seq, _q in read_fastx(read_file)}
    else:
        X_original = {acc: seq for acc, seq in read_fasta(read_file)}

    assigned = {
        x_acc for c_acc in read_partition for x_acc in read_partition[c_acc]
    }
    X = {
        acc: seq
        for acc, seq in X_original.items()
        if acc in assigned or acc in to_realign
    }

    if os.stat(candidate_file).st_size == 0:
        _write_final(params, {}, {}, {}, X)
        return {}
    C = {acc: seq for acc, seq in read_fasta(candidate_file)}

    # quality values (``:177-200``)
    if params.is_fastq:
        raw = {}
        for x_acc, seq, qual in read_fastx(read_file):
            key = x_acc.split(" ")[0]
            raw[key] = CCS(key, seq, [ord(c) - 33 for c in qual], "NA")
        X_ids = {x_acc.split(" ")[0]: x_acc for x_acc in X}
        ccs_dict = ccs_dict_from_fastq(raw, X_ids, X)
        for x_acc in X:
            assert X[x_acc] == ccs_dict[x_acc].seq
    elif params.ccs:
        from ..io.bam import read_ccs_bam

        raw = read_ccs_bam(params.ccs)
        X_ids = {"/".join(x_acc.split("/")[:2]): x_acc for x_acc in X}
        ccs_dict = ccs_dict_from_bam(raw, X_ids, X)
        for x_acc in X:
            assert X[x_acc] == ccs_dict[x_acc].seq
    else:
        ccs_dict = {}

    # static ends-ignored candidate graph (``:203-206``)
    with record_function("isocon_phase2.static_graph"):
        static_graph = ends_ignored_nn_graph(C, params.ignore_ends_len,
                                             engine)

    step = 1
    previous_partition_of_X = copy.deepcopy(read_partition)
    previous_edges: Dict[str, Set] = {c_acc: set() for c_acc in C}
    significance_values: Dict[str, Dict[str, tuple]] = {}
    realignment_to_avoid_local_max = 0
    modified = True
    highest_significance_values: Dict[str, tuple] = {}
    # the reads' alignments as the tests read them, each converted once
    store = AlignmentStore(engine.counters)

    while modified:
        modified = False

        # per-round scratch artifacts, matching the reference's disk-IPC
        # spill for mid-run inspectability (``:257-263,280-282``); guarded
        # like candidates.py so library callers without an outfolder work
        if params.outfolder:
            with open(os.path.join(params.outfolder,
                                   "temp_candidates_step_{0}.fa".format(step)),
                      "w") as fh:
                for c_acc, c_seq in C.items():
                    fh.write(">{0}\n{1}\n".format(c_acc, c_seq))

        if realignment_to_avoid_local_max == 1:
            to_realign = dict(X)
            read_partition = {c_acc: {} for c_acc in C}

        if to_realign:
            if params.outfolder:
                with open(os.path.join(params.outfolder,
                                       "remaining_to_align.fa"), "w") as fh:
                    for r_acc, r_seq in to_realign.items():
                        fh.write(">{0}\n{1}\n".format(r_acc, r_seq))
            # 2-set NN assignment + alignments (``:278-316``)
            with record_function("isocon_phase2.assign"):
                nn2 = nearest_neighbors_2set(to_realign, C, engine)
                partition_of_realigned = greedy_bipartite_assignment(
                    {r: list(cs) for r, cs in nn2.items()},
                    sorted({c for cs in nn2.values() for c in cs}),
                )
                pairs = []
                keys = []
                for c_acc in partition_of_realigned:
                    for read_acc in partition_of_realigned[c_acc]:
                        pairs.append((C[c_acc], X[read_acc]))
                        keys.append((c_acc, read_acc))
                _eds, alns = align_pair_list(engine, pairs)
                aligned: Dict[str, Dict[str, tuple]] = {}
                for (c_acc, read_acc), aln in zip(keys, alns):
                    aligned.setdefault(c_acc, {})[read_acc] = aln
                filter_exon_differences(
                    aligned, params.min_exon_diff, params.ignore_ends_len
                )
                for c_acc in aligned:
                    for read_acc in aligned[c_acc]:
                        read_partition[c_acc][read_acc] = (
                            aligned[c_acc][read_acc])
                for c_acc in list(read_partition.keys()):
                    if len(read_partition[c_acc]) == 0:
                        del C[c_acc]
                        del read_partition[c_acc]

        # per-round test edges: min surviving static-graph distance (``:325-338``)
        nn_graph: Dict[str, Dict[str, int]] = {}
        for c_acc in C:
            nn_graph[c_acc] = {}
            nbrs = static_graph.get(c_acc, {})
            alive = {t: ed for t, ed in nbrs.items() if t in C}
            if alive:
                min_ed = min(alive.values())
                for t, ed in alive.items():
                    if ed == min_ed:
                        nn_graph[c_acc][t] = min_ed

        if realignment_to_avoid_local_max > 0:
            homo = get_homopolymer_invariants(C)
            for c_acc in homo:
                nn_graph.setdefault(c_acc, {})
                for t_acc in homo[c_acc]:
                    if t_acc not in nn_graph[c_acc]:
                        nn_graph[c_acc][t_acc] = 1

        # dominance skip + memoization (``:379-404``)
        previous_significance_values: Dict[str, Dict[str, tuple]] = {}
        for c_acc in list(nn_graph.keys()):
            for t_acc in list(nn_graph[c_acc].keys()):
                if len(read_partition[c_acc]) >= params.min_test_ratio * len(
                    read_partition[t_acc]
                ):
                    del nn_graph[c_acc][t_acc]
            previous_significance_values[c_acc] = {}
            to_remove = set()
            for t_acc in list(nn_graph[c_acc].keys()):
                if (
                    (c_acc, t_acc) in previous_edges.get(c_acc, set())
                    and previous_partition_of_X.get(t_acc) == read_partition.get(t_acc)
                    and previous_partition_of_X.get(c_acc) == read_partition.get(c_acc)
                ):
                    previous_significance_values[c_acc][t_acc] = (
                        significance_values[c_acc][t_acc]
                    )
                    to_remove.add((c_acc, t_acc))
            previous_edges[c_acc] = {
                (c_acc, t_acc) for t_acc in nn_graph[c_acc]
            }
            for c_a, t_a in to_remove:
                del nn_graph[c_a][t_a]

        nr_tests = sum(len(v) for v in nn_graph.values())
        nr_memoized = sum(
            len(v) for v in previous_significance_values.values())
        # per-step test telemetry (the reference's STEP NR banner +
        # edge/test prints, ``isocon_statistical_test.py:250,340,509``)
        logger(
            "stat_filter STEP NR {0}: {1} candidates, {2} new tests, "
            "{3} memoized, {4} reads realigned".format(
                step, len(C), nr_tests, nr_memoized,
                len(to_realign)),
            params.logfile,
        )
        if nr_tests > 0:
            with record_function("isocon_phase2.tests"):
                new_significance = do_statistical_tests_per_edge(
                    nn_graph, C, read_partition, ccs_dict, params, engine,
                    store,
                )
            for c_acc in new_significance:
                for t_acc in new_significance[c_acc]:
                    previous_significance_values[c_acc][t_acc] = (
                        new_significance[c_acc][t_acc]
                    )
        significance_values = copy.deepcopy(previous_significance_values)

        assert len(significance_values) == len(C)
        highest_significance_values = {}
        for c_acc in significance_values:
            corrected_max = 0.0
            highest = (
                c_acc, "", "not_tested", 1.0,
                len(read_partition[c_acc]), len(read_partition[c_acc]), "",
            )
            for t_acc, (p_value, factor, k, N_t, variants) in (
                significance_values[c_acc].items()
            ):
                corr = product_with_check_overflow(p_value, factor)
                if corr >= corrected_max:
                    corrected_max = corr
                    highest = (c_acc, t_acc, p_value, factor, k, N_t, variants)
            highest_significance_values[c_acc] = highest

        # adaptive threshold: median of corrected p-values (``:440-453``)
        corrected_pvals = sorted(
            product_with_check_overflow(p, f)
            for (_c, _t, p, f, _k, _N, _v) in highest_significance_values.values()
            if p != "not_tested"
        )
        if corrected_pvals:
            n = len(corrected_pvals)
            if n % 2 == 0:
                med = (corrected_pvals[n // 2 - 1] + corrected_pvals[n // 2]) / 2.0
            else:
                med = corrected_pvals[n // 2]
            p_val_threshold = med if med > params.p_value_threshold else (
                params.p_value_threshold
            )
        else:
            p_val_threshold = params.p_value_threshold

        to_realign = {}
        pv_rows = []
        for c_acc, (c_acc_, t_acc, p_value, factor, k, N_t, variants) in (
            highest_significance_values.items()
        ):
            if p_value == "not_tested":
                pass
            elif k == 0 or product_with_check_overflow(p_value, factor) >= (
                p_val_threshold
            ):
                del C[c_acc]
                modified = True
                for x_acc in read_partition[c_acc]:
                    to_realign[x_acc] = X[x_acc]
                del read_partition[c_acc]
            if p_value != "not_tested":
                corr = 1.0 if k == 0 else min(
                    1.0, product_with_check_overflow(p_value, factor)
                )
                pv_rows.append(
                    "{0}\t{1}".format(
                        c_acc + "_" + str(k) + "_" + str(corr) + "_"
                        + str(N_t) + "_" + str(len(variants)),
                        str(p_value),
                    )
                )
        if params.outfolder:
            with open(
                os.path.join(params.outfolder, "p_values_{0}.tsv".format(step)),
                "w",
            ) as fh:
                fh.write("\n".join(pv_rows) + ("\n" if pv_rows else ""))

        if params.verbose:
            # per-edge corrected p-values into the develop log, mirroring
            # the reference's verbose p-value prints
            # (``isocon_statistical_test.py:430-436``)
            for c_acc, (c_a, t_acc, p_value, factor, k, N_t, variants) in (
                sorted(highest_significance_values.items())
            ):
                if p_value == "not_tested":
                    devlog(params, "step {0} {1}: not tested (support {2})"
                           .format(step, c_acc, N_t))
                else:
                    devlog(
                        params,
                        "step {0} {1} vs {2}: p={3} mult={4} k={5} N_t={6} "
                        "variants={7}".format(
                            step, c_acc, t_acc, p_value, factor, k, N_t,
                            len(variants)),
                    )
            devlog(params, "step {0} threshold {1} ({2} tested)".format(
                step, p_val_threshold, len(corrected_pvals)))

        previous_partition_of_X = copy.deepcopy(read_partition)
        step += 1
        if len(C) == 0:
            break

        if params.outfolder:
            print_candidates(
                os.path.join(
                    params.outfolder,
                    "candidates_after_step_{0}.fa".format(step - 1),
                ),
                C, highest_significance_values, read_partition, X,
            )

        # local-max escape state machine (``:500-506``)
        if realignment_to_avoid_local_max == 1:
            realignment_to_avoid_local_max = 2
        elif not modified and realignment_to_avoid_local_max == 0:
            realignment_to_avoid_local_max = 1
            modified = True
        logger("stat_filter step {0}: {1} candidates".format(step - 1, len(C)),
               params.logfile)

    # final end-invariant collapse (``:513-529``)
    if params.ignore_ends_len > 0 and C:
        support = {
            c_acc: len(reads) for c_acc, reads in read_partition.items()
        }
        remaining = collapse_candidates_under_ends_invariant(
            C, support, params.ignore_ends_len
        )
        for c_acc in remaining:
            for removed in remaining[c_acc]:
                for read_acc, aln in read_partition[removed].items():
                    read_partition[c_acc][read_acc] = aln
                del C[removed]
                del read_partition[removed]

    _write_final(params, C, highest_significance_values, read_partition, X)
    return C


def _write_final(params, C, highest_significance_values, read_partition, X):
    out = os.path.join(params.outfolder, "final_candidates.fa")
    tsv = os.path.join(params.outfolder, "cluster_info.tsv")
    sig = dict(highest_significance_values)
    for c_acc in C:
        if c_acc not in sig:
            sig[c_acc] = (c_acc, "", "not_tested", 1.0,
                          len(read_partition.get(c_acc, {})),
                          len(read_partition.get(c_acc, {})), "")
    print_candidates(out, C, sig, read_partition, X, final=True,
                     reads_to_consensus_tsv=tsv)
