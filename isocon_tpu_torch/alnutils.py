"""Alignment-string helpers shared by correction and testing phases.

Re-implementations of ``functions.py`` helpers operating on aligned string
pairs (with '-' gaps).
"""
from __future__ import annotations

import re
from typing import Dict, Set, Tuple

import numpy as np

_GAP_RUN = re.compile(r"[-]+")
_DASH = np.uint8(ord("-"))


def _bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin1"), dtype=np.uint8)


def get_mask_start_and_end(aln_a: str, aln_b: str) -> Tuple[int, int]:
    """Mask leading/trailing gap runs caused by length differences
    (``functions.py:218-236``)."""
    mask_start, mask_end = 0, len(aln_a)
    for m in _GAP_RUN.finditer(aln_a):
        if m.start() == 0:
            mask_start = m.end()
        if m.end() == len(aln_a):
            mask_end = m.start()
    for m in _GAP_RUN.finditer(aln_b):
        if m.start() == 0:
            assert mask_start == 0
            mask_start = m.end()
        if m.end() == len(aln_a):
            assert mask_end == len(aln_a)
            mask_end = m.start()
    return mask_start, mask_end


def filter_exon_differences(
    pairwise: Dict[str, Dict[str, Tuple[str, str, Tuple[int, int, int]]]],
    min_exon_diff: int,
    ignore_ends_len: int,
) -> Set[str]:
    """Drop alignments with an interior gap run >= min_exon_diff
    (``functions.py:23-50``).  Mutates `pairwise` in place; returns the set
    of second keys removed."""
    pattern = re.compile(r"[-]{%d,}" % min_exon_diff)
    filtered: Set[str] = set()
    for s1 in list(pairwise.keys()):
        for s2 in list(pairwise[s1].keys()):
            a1, a2, _stats = pairwise[s1][s2]
            start, end = get_mask_start_and_end(a1, a2)
            start = min(ignore_ends_len, start)
            end = max(len(a1) - ignore_ends_len, end)
            if pattern.search(a1[start:end]) or pattern.search(a2[start:end]):
                del pairwise[s1][s2]
                filtered.add(s2)
    return filtered


def read_errors_from_alignment(ref_aln: str, read_aln: str) -> Tuple[int, int, int]:
    """(insertions, deletions, substitutions) of the read vs the reference,
    end gap runs excluded (``functions.py:495-522``).  Phase 2's tests take
    these counts from ``stats/store.py``, which computes them for many
    alignments in one pass; this is the form for one."""
    a = _bytes(ref_aln)
    b = _bytes(read_aln)
    n = len(a)

    def lead(arr):
        nz = np.flatnonzero(arr != _DASH)
        return int(nz[0]) if nz.size else len(arr)

    start = max(lead(a), lead(b))
    stop = n - max(lead(a[::-1]), lead(b[::-1]))
    if stop <= start:
        return 0, 0, 0
    aa = a[start:stop]
    bb = b[start:stop]
    diff = aa != bb
    ins = int((diff & (aa == _DASH)).sum())
    dele = int((diff & (bb == _DASH)).sum())
    subs = int(diff.sum()) - ins - dele
    return ins, dele, subs


def alignment_stats(a1: str, a2: str) -> Tuple[int, int, int]:
    x = _bytes(a1)
    y = _bytes(a2)
    eq = x == y
    matches = int((eq & (x != _DASH)).sum())
    mismatches = int((~eq & (x != _DASH) & (y != _DASH)).sum())
    return matches, mismatches, len(a1) - matches - mismatches
