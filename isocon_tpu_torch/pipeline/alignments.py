"""Pair-list alignment orchestration shared by both phases.

The reference runs every alignment twice: first edlib for the exact edit
distance, then parasail with a mismatch penalty chosen from the edlib error
rate (``SW_alignment_module.py:103-109``).  Here the first pass is the
banded wavefront kernel, whose result seeds both the penalty choice and the
alignment kernel's band width.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..alnutils import alignment_stats


def adaptive_mismatch_penalty(ed: int, len1: int, len2: int) -> int:
    """``SW_alignment_module.py:103-109``."""
    error_rate = float(ed) / min(len1, len2)
    if error_rate <= 0.01:
        return -1
    if error_rate <= 0.09:
        return -2
    return -4


def align_pair_list(
    engine,
    pairs: Sequence[Tuple[str, str]],
    eds: Optional[Sequence[int]] = None,
) -> Tuple[List[int], List[Tuple[str, str, Tuple[int, int, int]]]]:
    """Exact NW edit distances + adaptive-penalty semi-global alignments.

    Returns (eds, alignments); alignments[i] = (a1, a2, (m, x, i)).
    Routes through the engine's index API (one registration pass, then
    index-array batches).
    """
    ia = engine.add_seqs([p[0] for p in pairs])
    ib = engine.add_seqs([p[1] for p in pairs])
    if eds is None:
        ed_arr, _ = engine.edit_distances_idx(ia, ib)
        eds = [int(d) for d in ed_arr]
    la = engine.table_lens(ia)
    lb = engine.table_lens(ib)
    lmin = np.minimum(la, lb)
    scores = [
        (2, adaptive_mismatch_penalty(d, m, m), 2, 0)
        for d, m in zip(eds, lmin.tolist())
    ]
    alns = engine.align_pairs_idx(ia, ib, scores, ed_hint=eds)
    return list(eds), alns
