"""The least operations and bytes an exact banded method needs for the
answers the engine gave, and the least time they take on the card.

The per-word, per-cell and per-step operation counts, the lane counts
and the bound are frozen copies of ``chip_smoke.py`` (commit 2110776:
``MYERS_ALU_OPS_PER_WORD``, ``AFFINE_OPS_PER_CELL``,
``AFFINE_OPS_PER_DIAGONAL``, ``WALK_OPS_PER_STEP``, ``SMS``,
``INT32_LANES_PER_SM``, ``HBM_BYTES_PER_S`` and ``bound_ms``), where each
is argued.  The count reads only each pair's lengths, its cap and the
answer (an alignment's own columns); never the windows, bands, rungs,
routes or launch sizes the engine chose, so it stays the same work
whatever implements it.

Edit distances, every pair, NW or HW, short or long: Myers' 8 ALU-only
operations a 32-row word of the band the answer needs, in each of the
target's columns.  The band holds the diagonals a path of that cost can
use: d + 1 for NW (Ukkonen: from -(d - delta)/2 to delta + (d - delta)/2),
2d + 1 for HW (around the diagonal of the span's end, whose start may
move d either way), at most the query's rows.  d is the distance, or the
cap where the answer is "above the cap" (that many rows prove it); a NW
pair whose length difference exceeds its cap needs no DP at all.  Bytes:
both sequences' codes and four int32 read, the answer written (HW: with
its end column).

Alignments: K3's 20 operations a band cell and 2 a diagonal over the
n + m - 1 anti-diagonals, with (g + 1) / 2 cells of the band on each, g
the gap columns between the alignment's first and last aligned column
(the band its indels need); then K4's 16 a step over those columns.
Bytes: both codes and eight int32 read, a direction byte a band cell
written, and read again once a step, the steps' opcodes and twelve bytes
of endpoints written.
"""
from __future__ import annotations

import numpy as np

SMS = 132
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
MYERS_ALU_OPS_PER_WORD = 8
AFFINE_OPS_PER_CELL = 20
AFFINE_OPS_PER_DIAGONAL = 2
WALK_OPS_PER_STEP = 16
DASH = ord("-")


def bound_s(nbytes: float, ops: float, clock_mhz: float):
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over 3.35 TB/s and the int32 operations over 132 SMs x 64 lanes x the
    SM clock."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": ops / (SMS * INT32_LANES_PER_SM * clock_mhz
                                  * 1e6)}
    by = max(terms, key=terms.get)
    return terms[by], by


def ed_work(n: np.ndarray, m: np.ndarray, answer: np.ndarray,
            cap: np.ndarray, hw: bool):
    """(operations, bytes) of a batch of edit distances: query lengths n,
    target lengths m, the answers (-1: above the cap) and the caps."""
    n = np.asarray(n, dtype=np.int64)
    m = np.asarray(m, dtype=np.int64)
    answer = np.asarray(answer, dtype=np.int64)
    cap = np.asarray(cap, dtype=np.int64)
    d = np.where(answer >= 0, answer, cap)
    # an "above the cap" answer may come with a cap past any length
    d = np.minimum(d, n + m)
    rows = np.minimum(2 * d + 1 if hw else d + 1, n)
    words = (rows + 31) // 32
    need = (n > 0) & (m > 0)
    if not hw:
        need &= np.abs(n - m) <= cap
    ops = float((np.where(need, words * m, 0)).sum()) * MYERS_ALU_OPS_PER_WORD
    nbytes = float(np.where(need, n + m + 16 + (8 if hw else 4), 0).sum())
    return ops, nbytes


def align_work(n: np.ndarray, m: np.ndarray, gaps: np.ndarray,
               steps: np.ndarray):
    """(operations, bytes) of a batch of alignments: lengths n and m, gap
    columns between the first and last aligned column, and those
    columns (the walk's steps)."""
    n = np.asarray(n, dtype=np.int64)
    m = np.asarray(m, dtype=np.int64)
    gaps = np.asarray(gaps, dtype=np.int64)
    steps = np.asarray(steps, dtype=np.int64)
    need = (n > 0) & (m > 0)
    diagonals = np.where(need, n + m - 1, 0)
    cells = diagonals * ((gaps + 2) // 2)
    ops = (float(cells.sum()) * AFFINE_OPS_PER_CELL
           + float(diagonals.sum()) * AFFINE_OPS_PER_DIAGONAL
           + float(np.where(need, steps, 0).sum()) * WALK_OPS_PER_STEP)
    nbytes = float(np.where(need, n + m + 32 + 12, 0).sum()
                   + cells.sum() + 2 * np.where(need, steps, 0).sum())
    return ops, nbytes


def aligned_span(a1: str, a2: str):
    """(gap columns, columns) between the first and the last column of
    (a1, a2) where both hold a base."""
    x = np.frombuffer(a1.encode("latin1"), dtype=np.uint8)
    y = np.frombuffer(a2.encode("latin1"), dtype=np.uint8)
    both = np.flatnonzero((x != DASH) & (y != DASH))
    if both.size == 0:
        return 0, 0
    cols = int(both[-1] - both[0] + 1)
    return cols - int(both.size), cols
