"""Phase 1: candidate generation (the correction loop).

Re-implements ``isocon_get_candidates.py:85-312`` on the batched engine:
iteratively partition reads around nearest-neighbor centers, align every
member to its center, majority-correct half the minority positions, until
the multiset of edit distances converges (identical copies emerge).

Each step of an iteration is a span of a profiler trace, entered once an
iteration: ``isocon_phase1.nn_graph`` (the NN graph), ``.partition`` (the
star partition), ``.align`` (the star alignments and their exon filter;
once more for the final read -> candidate alignments) and ``.correct``
(MAM correction).
"""
from __future__ import annotations

import os
from collections import Counter
from typing import Dict, Optional, Set, Tuple

from torch.profiler import record_function

from ..graph.end_invariant import collapse_candidates_under_ends_invariant
from ..graph.nn import nearest_neighbors
from ..graph.partition import star_partition
from ..correct.consensus import correct_strings
from ..alnutils import filter_exon_differences
from ..io import read_fasta, read_fastx
from ..io.output import devlog, logger, print_candidates_from_nearest_neighbors
from .alignments import align_pair_list


def _log_iteration_telemetry(params, step, S, seq_to_acc, edges,
                             partition_alignments, exon_filtered):
    """Per-iteration diagnostics matching the reference's verbosity
    (``isocon_get_candidates.py:109-123,193-199`` prints + the
    seq-length histogram written to the develop log at ``:116-118``)."""
    lengths = sorted(len(s) for s in seq_to_acc)
    logger(
        "Iteration {0}: {1} reads, {2} unique seqs, {3} NN edges, "
        "{4} partitions, lengths {5}-{6}, {7} exon-filtered".format(
            step, len(S), len(seq_to_acc), len(edges),
            len(partition_alignments), lengths[0] if lengths else 0,
            lengths[-1] if lengths else 0, len(exon_filtered)),
        params.logfile,
    )
    if params.verbose:
        hist = Counter(lengths)
        for l in sorted(hist):
            devlog(params, "seq length {0}: {1} occurances".format(
                l, hist[l]))
        sizes = sorted(
            (len(v) for v in partition_alignments.values()), reverse=True)
        devlog(params, "iteration {0} partition sizes (desc): {1}".format(
            step, sizes[:50]))


def get_unique_seq_accessions(S: Dict[str, str]) -> Dict[str, list]:
    """{seq: [accessions]} (``isocon_get_candidates.py:23-35``)."""
    seq_to_acc: Dict[str, list] = {}
    for acc, seq in S.items():
        seq_to_acc.setdefault(seq, []).append(acc)
    return seq_to_acc


def partition_strings(S: Dict[str, str], params, engine):
    """NN graph + star partition over the current read strings.

    Mirrors ``partitions.py:416-593`` + ``graphs.py:29-82``: nodes are
    unique sequences weighted by multiplicity; only multiplicity-1 nodes get
    NN out-edges.  Returns (edges, degrees-by-seq, partition {center: set},
    M {center: weight}, converged).
    """
    seq_to_acc = get_unique_seq_accessions(S)
    unique_seqs = sorted(seq_to_acc)
    degrees = {s: len(seq_to_acc[s]) for s in unique_seqs}
    converged = all(d > 1 for d in degrees.values())
    if converged:
        return [], degrees, {s: set() for s in unique_seqs}, \
            {s: 0 for s in unique_seqs}, True

    conv_mask = [degrees[s] > 1 for s in unique_seqs]
    with record_function("isocon_phase1.nn_graph"):
        if getattr(params, "nontargeted", False):
            # approximate sketch-retrieval path (the reference's dormant
            # minimap mode, graphs.py:85-149)
            from ..graph.sketch import approximate_nn_graph

            nn = approximate_nn_graph(unique_seqs, conv_mask, engine)
        else:
            nn = nearest_neighbors(
                unique_seqs, conv_mask, engine,
                depth=(params.neighbor_search_depth
                       if params.neighbor_search_depth < 2 ** 31 else None),
            )
    with record_function("isocon_phase1.partition"):
        edges = [
            (i, j) for i, d in enumerate(nn) for j in d if not conv_mask[i]
        ]
        deg_list = [degrees[s] for s in unique_seqs]
        M_idx, part_idx = star_partition(unique_seqs, deg_list, edges)
        partition = {
            unique_seqs[c]: {unique_seqs[x] for x in members}
            for c, members in part_idx.items()
        }
        M = {unique_seqs[c]: w for c, w in M_idx.items()}
        edge_seqs = [(unique_seqs[i], unique_seqs[j]) for i, j in edges]
    return edge_seqs, degrees, partition, M, False


def get_partition_alignments(
    partition: Dict[str, Set[str]],
    M: Dict[str, int],
    degrees: Dict[str, int],
    exon_filtered: Set[str],
    params,
    engine,
):
    """Align every member to its center; drop exon-difference members
    (``isocon_get_candidates.py:37-81``).

    Returns {m: {s: (edit_dist, m_aln, s_aln, degree)}} where edit_dist =
    mismatches + indels of the semi-global alignment (``:74``).
    """
    with record_function("isocon_phase1.align"):
        pairs = []
        keys = []
        for m in sorted(partition):
            for s in sorted(partition[m]):
                pairs.append((m, s))
                keys.append((m, s))
        eds, alns = align_pair_list(engine, pairs)

        exact_alignments: Dict[str, Dict[str, tuple]] = {}
        for (m, s), aln in zip(keys, alns):
            exact_alignments.setdefault(m, {})[s] = aln
        filtered = filter_exon_differences(
            exact_alignments, params.min_exon_diff, params.ignore_ends_len
        )
        exon_filtered.update(filtered)

        partition_alignments: Dict[str, Dict[str, tuple]] = {}
        for m in M:
            selfdegree = degrees.get(m, 1)
            partition_alignments[m] = {m: (0, m, m, selfdegree)}
            for s, (aln_m, aln_s, (mat, mis, ind)) in (
                    exact_alignments.get(m, {}).items()):
                partition_alignments[m][s] = (mis + ind, aln_m, aln_s, 1)
    return partition_alignments


def find_candidate_transcripts(read_file: str, params, engine):
    """The phase-1 loop (``isocon_get_candidates.py:85-312``).

    Returns (candidates_file_name, read_partition, to_realign) where
    read_partition[c_acc][read_acc] = (c_aln, read_aln, stats).
    """
    if params.is_fastq:
        S = {acc: seq for acc, seq, _q in read_fastx(read_file)}
    else:
        S = {acc: seq for acc, seq in read_fasta(read_file)}
    original_reads = dict(S)
    # cumulative unique-sequence count over all correction rounds is
    # ~3.5x the initial uniques (each round re-interns the corrected
    # strings); reserving it keeps the device-pool shape fixed for the
    # whole run (PairEngine.reserve_pool_rows -- no-op on small runs)
    engine.reserve_pool_rows(4 * len(set(S.values())))

    step = 1
    exon_filtered: Set[str] = set()
    seq_to_acc = get_unique_seq_accessions(S)

    edges, degrees, partition, M, converged = partition_strings(S, params, engine)
    partition_alignments = get_partition_alignments(
        partition, M, degrees, exon_filtered, params, engine
    )
    _log_iteration_telemetry(params, step, S, seq_to_acc, edges,
                             partition_alignments, exon_filtered)

    prev_ed_2steps_ago = [2 ** 28, 2 ** 28, 2 ** 28]
    prev_ed = [2 ** 28]

    while not converged:
        edit_distances = sorted(
            partition_alignments[s1][s2][0]
            for s1 in partition_alignments
            for s2 in partition_alignments[s1]
        )
        # convergence criteria (``:148-184``)
        if prev_ed_2steps_ago == edit_distances:
            break  # 2-cycle
        if sum(edit_distances) > sum(prev_ed) and max(edit_distances) > max(prev_ed):
            break  # non-improving
        if all(ed == 0 for ed in edit_distances):
            break  # normal convergence

        with record_function("isocon_phase1.correct"):
            S_prime, _S_prime_qual = correct_strings(
                partition_alignments, seq_to_acc, step,
                verbose=params.verbose, engine=engine
            )
        for acc, s_prime in S_prime.items():
            S[acc] = s_prime

        seq_to_acc = get_unique_seq_accessions(S)
        step += 1
        S_to_align = {
            acc: seq for acc, seq in S.items() if seq not in exon_filtered
        }
        edges, degrees, partition, M, converged = partition_strings(
            S_to_align, params, engine
        )
        partition_alignments = get_partition_alignments(
            partition, M, degrees, exon_filtered, params, engine
        )
        _log_iteration_telemetry(params, step, S, seq_to_acc, edges,
                                 partition_alignments, exon_filtered)
        if params.outfolder:
            out_name = os.path.join(
                params.outfolder, "candidates_step_" + str(step) + ".fa"
            )
            with open(out_name, "w") as fh:
                for i, m in enumerate(partition_alignments):
                    N_t = sum(
                        t[3] for t in partition_alignments[m].values()
                    )
                    fh.write(
                        ">{0}\n{1}\n".format(
                            "read" + str(i) + "_support_" + str(N_t), m
                        )
                    )
        prev_ed_2steps_ago = prev_ed
        prev_ed = edit_distances
        logger(
            "Correction step {0} done; {1} unique seqs".format(
                step, len(seq_to_acc)
            ),
            params.logfile,
        )

    # candidate naming (``:219-238``)
    c_seq_to_read_acc: Dict[str, list] = {}
    for read_acc, seq in S.items():
        c_seq_to_read_acc.setdefault(seq, []).append(read_acc)

    c_acc_to_seq: Dict[str, str] = {}
    c_acc_to_support: Dict[str, int] = {}
    for i, m in enumerate(sorted(c_seq_to_read_acc)):
        if m in partition_alignments:
            N_t = partition_alignments[m][m][3]
        else:
            N_t = 1  # did not converge
        c_acc = "transcript_" + str(i) + "_support_" + str(N_t)
        c_acc_to_seq[c_acc] = m
        c_acc_to_support[c_acc] = N_t

    # end-invariant collapse (``:240-255``)
    if params.ignore_ends_len > 0:
        remaining = collapse_candidates_under_ends_invariant(
            c_acc_to_seq, c_acc_to_support, params.ignore_ends_len
        )
        for c_acc in remaining:
            c_seq = c_acc_to_seq[c_acc]
            for removed_acc in remaining[c_acc]:
                removed_seq = c_acc_to_seq[removed_acc]
                for read_acc in c_seq_to_read_acc[removed_seq]:
                    c_seq_to_read_acc[c_seq].append(read_acc)
                del c_acc_to_seq[removed_acc]
                del c_acc_to_support[removed_acc]
                del c_seq_to_read_acc[removed_seq]

    assert len(S) == len(original_reads)

    # support filter (``:268-277``)
    for c_acc in list(c_acc_to_seq.keys()):
        if c_acc_to_support[c_acc] < params.min_candidate_support:
            c_seq = c_acc_to_seq[c_acc]
            del c_acc_to_seq[c_acc]
            del c_seq_to_read_acc[c_seq]
            del c_acc_to_support[c_acc]

    assigned = {
        read_acc
        for c_seq in c_seq_to_read_acc
        for read_acc in c_seq_to_read_acc[c_seq]
    }
    to_realign = {
        read_acc: original_reads[read_acc]
        for read_acc in set(original_reads) - assigned
    }

    candidates_file_name = os.path.join(
        params.outfolder, "candidates_converged.fa"
    ) if params.outfolder else "candidates_converged.fa"
    print_candidates_from_nearest_neighbors(candidates_file_name, c_acc_to_seq)
    if params.outfolder:
        open(os.path.join(params.outfolder, "not_converged.fa"), "w").close()

    # final read -> candidate alignments (``:295-311``)
    with record_function("isocon_phase1.align"):
        pairs = []
        keys = []
        for c_acc in sorted(c_acc_to_seq):
            c_seq = c_acc_to_seq[c_acc]
            for read_acc in c_seq_to_read_acc[c_seq]:
                pairs.append((c_seq, original_reads[read_acc]))
                keys.append((c_acc, read_acc))
        eds, alns = align_pair_list(engine, pairs)
        read_partition: Dict[str, Dict[str, tuple]] = {
            c_acc: {} for c_acc in c_acc_to_seq
        }
        for (c_acc, read_acc), aln in zip(keys, alns):
            read_partition[c_acc][read_acc] = aln
        filtered_reads = filter_exon_differences(
            read_partition, params.min_exon_diff, params.ignore_ends_len
        )
        for read_acc in filtered_reads:
            to_realign[read_acc] = original_reads[read_acc]

    return candidates_file_name, read_partition, to_realign
