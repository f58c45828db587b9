"""CCS quality-value records (``ccs_info.py``).

Holds per-read phred qualities and maps alignment positions back to CCS
coordinates.  Used by the fastq path of the statistical test
(``isocon_statistical_test.py:177-189``) and by BAM ingestion.
"""
from __future__ import annotations

import re
import sys
from typing import Dict, List

_COMP = str.maketrans(
    "ACGTacgtNnXYRKMSWBVHDyrkmswbvhd",
    "TGCAtgcaNnXRYMKSWVBDHrymkswvbdh",
)


def reverse_complement(s: str) -> str:
    return s.translate(_COMP)[::-1]


class CCS:
    """``ccs_info.py:9-123``."""

    def __init__(self, name: str, seq: str, qual: List[int], np_passes):
        self.name = name
        self.seq = seq
        self.qual = list(qual)
        bad = [v for v in self.qual if v < 0 or v > 93]
        if bad:
            raise ValueError(
                "bad phred quality values in read {0}: {1}".format(name, bad[:5])
            )
        self.np = np_passes
        self.subreads: Dict = {}

    def read_aln_to_ccs_coord(self, read_aln: str, pos: int) -> int:
        """``ccs_info.py:36-57``: position in the aligned read's fasta
        sequence -> coordinate in the (possibly longer) ccs sequence."""
        fasta_seq = "".join(n for n in read_aln if n != "-")
        index = self.seq.index(fasta_seq)
        if index + pos < len(self.seq):
            return index + pos
        if index + pos == len(self.seq):
            return index + pos - 1
        raise IndexError(
            "ccs coord out of range: {0}+{1} vs {2}".format(
                index, pos, len(self.seq)
            )
        )

    def get_p_error_in_base(self, coord: int) -> float:
        return 10 ** (-self.qual[coord] / 10.0)


def fix_quality_values(seq: str, qualities: List[int]) -> List[int]:
    """Sort quality values ascending within homopolymer runs
    (``ccs_info.py:131-150``)."""
    assert len(seq) == len(qualities)
    out: List[int] = []
    run = [qualities[0]]
    for i in range(1, len(seq)):
        if seq[i - 1] == seq[i]:
            run.append(qualities[i])
        else:
            out.extend(sorted(run))
            run = [qualities[i]]
    out.extend(sorted(run))
    return out


def ccs_dict_from_fastq(records, X_ids: Dict[str, str], X: Dict[str, str]):
    """Build {pipeline read accession: CCS} from raw fastq records
    (``modify_strings_and_acc_fastq``, ``ccs_info.py:153-216``)."""
    out: Dict[str, CCS] = {}
    for q_id, ccs in records.items():
        if q_id not in X_ids:
            continue
        q_acc = X_ids[q_id]
        if re.search(r"strand=-", q_acc):
            qualities = fix_quality_values(ccs.seq, ccs.qual)
            start = ccs.seq.index(X[q_acc])
            stop = start + len(X[q_acc])
            ccs.seq = ccs.seq[start:stop]
            ccs.qual = qualities[start:stop]
        else:
            start = ccs.seq.index(X[q_acc])
            stop = start + len(X[q_acc])
            ccs.seq = ccs.seq[start:stop]
            ccs.qual = list(ccs.qual)[start:stop]
        assert ccs.seq == X[q_acc]
        assert len(ccs.seq) == len(ccs.qual)
        ccs.name = q_acc
        out[q_acc] = ccs
    assert len(out) == len(X_ids)
    return out


def ccs_dict_from_bam(records, X_ids: Dict[str, str], X: Dict[str, str]):
    """BAM variant (``modify_strings_and_acc``, ``ccs_info.py:219-297``):
    reverse-complements strand=- reads before slicing."""
    out: Dict[str, CCS] = {}
    for q_id, ccs in records.items():
        if q_id not in X_ids:
            continue
        q_acc = X_ids[q_id]
        if re.search(r"strand=-", q_acc):
            seq_rc = reverse_complement(ccs.seq)
            qual_r = ccs.qual[::-1]
            qualities = fix_quality_values(seq_rc, qual_r)
            start = seq_rc.index(X[q_acc])
            stop = start + len(X[q_acc])
            ccs.seq = seq_rc[start:stop]
            ccs.qual = qualities[start:stop]
        else:
            start = ccs.seq.index(X[q_acc])
            stop = start + len(X[q_acc])
            ccs.seq = ccs.seq[start:stop]
            ccs.qual = list(ccs.qual)[start:stop]
        assert ccs.seq == X[q_acc]
        assert len(ccs.seq) == len(ccs.qual)
        ccs.name = q_acc
        out[q_acc] = ccs
    assert len(out) == len(X_ids)
    return out
