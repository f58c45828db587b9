"""Majority-vote consensus correction of partition members.

Re-implements ``correction_module.py:260-446`` (``correct_to_consensus``)
and the per-partition fan-out ``correct_strings`` (``:12-75``).  For each
partition: build the star MAM + degree-weighted PFM, derive the per-column
majority (ambiguous-majority columns excluded from error statistics and
from correction), count partition error types (c_del / c_ins / c_subs),
then for every non-converged member correct the
ceil(0.5 * #unambiguous-minority-positions) positions with the smallest
type-normalized frequency PFM[j][v]/c_type, extending through ties at the
cutoff (``:389-400``).

The tie-extension compares float ratios; we reproduce the reference's IEEE
division exactly so decisions match bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .dense import build_dense_mam, check_round_trip, correct_round
from .mam import create_multialignment_matrix, create_position_frequency_matrix


def correct_strings(
    partition_alignments: Dict[str, Dict[str, Tuple[int, str, str, int]]],
    seq_to_acc: Dict[str, List[str]],
    step: int,
    verbose: bool = False,
    ccs_dict: Optional[Dict[str, object]] = None,
    engine=None,
) -> Tuple[Dict[str, str], Dict[str, list]]:
    """Correct every partition; returns ({accession: corrected sequence},
    {accession: corrected quality vector}).

    partition_alignments: {center m: {s: (ed, m_aln, s_aln, degree)}}
    (the center itself appears as (0, m, m, selfdegree)).  When ccs_dict is
    given, the quality-weighted variant is used
    (``correct_to_consensus_helper``, ``correction_module.py:78-84``), on
    the host.  Otherwise a partition of more than one member and a support
    above 2 is dense: the host builds its MAM (``dense.build_dense_mam``)
    and the round's dense partitions are voted on and corrected at once
    (``dense.correct_round``) on ``engine``'s device, the CPU without one;
    the others go to ``_correct_to_consensus_oracle``, which corrects
    nothing there.  The engine's counters ``consensus_rows_card`` and
    ``consensus_rows_host`` count the member rows of the dense partitions
    and those of the host's partitions of more than one member.
    """
    counters = engine.counters if engine is not None else None
    device = engine.device if engine is not None else torch.device("cpu")
    host_rows = 0
    # per partition in center order: its corrections, or its dense index
    done: List[object] = []
    dense: List[tuple] = []
    dense_s2a: List[Dict[str, List[str]]] = []
    s_prime_qual: Dict[str, list] = {}
    for m in sorted(partition_alignments):
        partition = partition_alignments[m]
        part_seq_to_acc = {}
        if m in seq_to_acc:
            part_seq_to_acc[m] = seq_to_acc[m]
        for s in partition:
            if s in seq_to_acc:
                part_seq_to_acc[s] = seq_to_acc[s]
        N_t = sum(t[3] for t in partition.values())
        if ccs_dict:
            part_ccs = {
                acc: ccs_dict[acc]
                for s in partition
                if s in seq_to_acc
                for acc in seq_to_acc[s]
                if acc in ccs_dict
            }
            corrected, quals = correct_to_consensus_ccs_qual(
                m, partition, part_seq_to_acc, step, part_ccs
            )
            s_prime_qual.update(quals)
        elif len(partition) > 1 and N_t > 2:
            accs, mat, degs = build_dense_mam(m, partition)
            check_round_trip(accs, mat)
            dense.append((accs, mat, degs))
            dense_s2a.append(part_seq_to_acc)
            done.append(len(dense) - 1)
            continue
        else:
            corrected = _correct_to_consensus_oracle(
                m, partition, part_seq_to_acc, step, verbose)
        if len(partition) > 1:
            host_rows += len(partition)
        done.append(corrected)
    if counters is not None:
        counters["consensus_rows_host"] += host_rows

    fixed = correct_round(dense, device, counters)
    s_prime: Dict[str, str] = {}
    for corrected in done:
        if isinstance(corrected, int):
            s2a = dense_s2a[corrected]
            corrected = {acc: t for s, t in fixed[corrected].items()
                         for acc in s2a[s]}
        for acc, s in corrected.items():
            assert acc not in s_prime
            s_prime[acc] = s
    return s_prime, s_prime_qual


def annotate_with_quality_values(
    alignment_matrix: Dict[str, List[str]],
    seq_to_acc: Dict[str, List[str]],
    ccs_dict,
):
    """Per-column summed/max quality PFMs (``correction_module.py:87-157``)."""
    qual_rows: Dict[str, List[int]] = {}
    max_qual_rows: Dict[str, List[int]] = {}
    for s, row in alignment_matrix.items():
        all_quals = [ccs_dict[acc].qual for acc in seq_to_acc[s]]
        sum_quals = [sum(t) for t in zip(*all_quals)]
        max_quals = [max(t) for t in zip(*all_quals)]
        list_sum, list_max = [], []
        pos = 0
        for ch in row:
            list_sum.append(sum_quals[pos])
            list_max.append(max_quals[pos])
            if ch != "-" and pos < len(sum_quals) - 1:
                pos += 1
        qual_rows[s] = list_sum
        max_qual_rows[s] = list_max

    ncol = len(next(iter(alignment_matrix.values())))
    pfm_q = [dict.fromkeys("ACGT-", 0) for _ in range(ncol)]
    pfm_maxq = [dict.fromkeys("ACGT-", 0) for _ in range(ncol)]
    for s, row in alignment_matrix.items():
        for j, ch in enumerate(row):
            pfm_q[j][ch] += qual_rows[s][j]
            pfm_maxq[j][ch] += max_qual_rows[s][j]

    majority = []
    for col in pfm_q:
        mx = max(col.values())
        majority.append("".join(sorted(v for v, c in col.items() if c == mx)))

    diffs = []
    for s, row in alignment_matrix.items():
        for j, ch in enumerate(row):
            if ch not in majority[j] and len(majority[j]) == 1:
                diffs.append(qual_rows[s][j])
    diffs.sort()
    if diffs:
        threshold = diffs[int(math.ceil(len(diffs) / 2.0)) - 1]
    else:
        threshold = -1
    return qual_rows, pfm_q, pfm_maxq, threshold


def correct_to_consensus_ccs_qual(
    m: str,
    partition: Dict[str, Tuple[int, str, str, int]],
    seq_to_acc: Dict[str, List[str]],
    step: int,
    ccs_dict,
) -> Tuple[Dict[str, str], Dict[str, list]]:
    """Quality-weighted correction (``correction_module.py:161-256``)."""
    s_prime: Dict[str, str] = {}
    s_prime_qual: Dict[str, list] = {}
    if len(partition) <= 1:
        return s_prime, s_prime_qual

    alignment_matrix = create_multialignment_matrix(m, partition)
    for s_before in partition:
        assert "".join(n for n in alignment_matrix[s_before] if n != "-") == s_before
    qual_rows, pfm_q, pfm_maxq, global_threshold = annotate_with_quality_values(
        alignment_matrix, seq_to_acc, ccs_dict
    )
    if global_threshold < 0:
        return s_prime, s_prime_qual

    majority = []
    for col in pfm_q:
        mx = max(col.values())
        majority.append("".join(sorted(v for v, c in col.items() if c == mx)))

    for s in sorted(partition):
        if partition[s][3] > 1:
            continue
        row = alignment_matrix[s]
        s_min = next(i for i, ch in enumerate(row) if ch != "-")
        s_max = len(row) - next(i for i, ch in enumerate(row[::-1]) if ch != "-")
        correctable = [
            (j, pfm_q[j][row[j]])
            for j in range(len(majority))
            if len(majority[j]) == 1 and majority[j] != row[j]
        ]
        nr_pos = int(math.ceil(len(correctable) * 0.5))
        if nr_pos == 0 or not correctable:
            continue
        correctable.sort(key=lambda x: x[1])
        _, qual_threshold = correctable[nr_pos - 1]
        to_correct = [(j, qj) for j, qj in correctable if qj <= qual_threshold]

        new_row = list(row)
        new_qual = list(qual_rows[s])
        for j, _qj in to_correct:
            assert len(majority[j]) == 1
            new_row[j] = majority[j]
            new_qual[j] = pfm_maxq[j][majority[j]]
        s_modified = "".join(n for n in new_row if n != "-")
        qual_modified = [new_qual[j] for j in range(len(new_row))
                         if new_row[j] != "-"]
        for acc in seq_to_acc[s]:
            s_prime[acc] = s_modified
            s_prime_qual[acc] = qual_modified
    return s_prime, s_prime_qual


def _correct_to_consensus_oracle(
    m: str,
    partition: Dict[str, Tuple[int, str, str, int]],
    seq_to_acc: Dict[str, List[str]],
    step: int,
    verbose: bool = False,
) -> Dict[str, str]:
    s_prime: Dict[str, str] = {}
    N_t = sum(t[3] for t in partition.values())

    if len(partition) > 1 and N_t > 2:
        alignment_matrix = create_multialignment_matrix(m, partition)
        pfm = create_position_frequency_matrix(alignment_matrix, partition)
        for s_before in partition:
            s_after = "".join(n for n in alignment_matrix[s_before] if n != "-")
            assert s_before == s_after

        c_del = c_ins = c_subs = 0
        majority_vector: List[str] = []
        for col in pfm:
            max_count = max(col.values())
            maxima = sorted(v for v, cnt in col.items() if cnt == max_count)
            # pick one representative max for error-type counting; direction
            # of counting only depends on whether it is "-" which is
            # unambiguous when |maxima| == 1 (ambiguous columns skipped)
            majority_vector.append("".join(maxima))
            if len(maxima) > 1:
                continue
            max_v = maxima[0]
            for v, cnt in col.items():
                if v == max_v:
                    continue
                if max_v == "-":
                    c_ins += cnt
                elif v == "-":
                    c_del += cnt
                else:
                    c_subs += cnt
        if verbose:
            print("Partition error types:", c_del, c_ins, c_subs, "depth:", N_t)

        for s in sorted(partition):
            if partition[s][3] > 1:
                continue  # converged member: never corrected (:316-317)
            row = alignment_matrix[s]
            nr_pos_to_correct = int(
                math.ceil(
                    len(
                        [
                            1
                            for j in range(len(majority_vector))
                            if len(majority_vector[j]) == 1
                            and majority_vector[j] != row[j]
                        ]
                    )
                    * 0.5
                )
            )
            if nr_pos_to_correct == 0:
                continue

            pos_freqs: List[Tuple[int, float]] = []
            for j in range(len(pfm)):
                maj = majority_vector[j]
                v_j = row[j]
                if v_j == maj or len(maj) > 1:
                    continue
                if maj == "-":
                    pos_freqs.append((j, pfm[j][v_j] / float(max(c_ins, 1))))
                elif v_j == "-":
                    pos_freqs.append((j, pfm[j][v_j] / float(max(c_del, 1))))
                else:
                    pos_freqs.append((j, pfm[j][v_j] / float(max(c_subs, 1))))
            if not pos_freqs:
                continue

            pos_freqs.sort(key=lambda x: x[1])  # stable: ties stay j-ascending
            if len(pos_freqs) < nr_pos_to_correct:
                end = len(pos_freqs)
            else:
                _, cutoff_freq = pos_freqs[nr_pos_to_correct - 1]
                end = nr_pos_to_correct
                for pp in range(nr_pos_to_correct, len(pos_freqs)):
                    if pos_freqs[pp][1] > cutoff_freq:
                        break
                    end += 1

            new_row = list(row)
            for j, _ in pos_freqs[:end]:
                assert len(majority_vector[j]) == 1
                new_row[j] = majority_vector[j]
            s_modified = "".join(n for n in new_row if n != "-")
            for acc in seq_to_acc[s]:
                s_prime[acc] = s_modified
    elif verbose and len(partition) > 1:
        ed = max(t[0] for t in partition.values())
        print(
            "Partition could not be corrected: size {0}, support {1}, ed {2}".format(
                len(partition), N_t, ed
            )
        )
    return s_prime
