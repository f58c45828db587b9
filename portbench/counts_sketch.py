"""The least operations and bytes of the sketch's top N (K6, ``--nontargeted``)
and the least time they take on the card.

The lane count and the operations a score are frozen copies of
``chip_smoke.py`` (``FP32_LANES_PER_SM``, ``SKETCH_OPS_PER_OUTPUT``), where
each is argued: an SM has 4 x 32 float32 FMA lanes (132 x 128 x 2 flops x
1,980 MHz is the published 67 TFLOP/s of float32 outside the tensor
cores), and a score needs its D = 512 products summed (512 FMA, one an
entry of the in-order chain that fixes the sum's rounding) and two
subtractions (the lengths' difference, and its subtraction from the
sum).

Scores: a call over n rows needs n(n - 1)/2 of them, not n x n.  The
diagonal is excluded, and score(i, j) = score(j, i) bit for bit:
|len_i - len_j| is symmetric, and each step of the chain,
fmaf(a_d, b_d, acc), is the same for both orders of its two factors (the
product is exact inside the fma), so the chain from (i, j) and from
(j, i) runs through the same values.  An exact top N over every pair
computes each score once and offers it to both rows' lists.  The engine's
counter ``sketch_score_cells`` is that count: the sum of n(n - 1)/2 over
the calls.  The count reads n alone, never the column segments, tiles or
launches K6 chose, so it stays the same work whatever implements it.  K6
computes both halves today, so it reads at most 50% of this roofline.

Bytes: each call's n x 512 float32 square-rooted profiles and n int32
lengths read once, its lists written, ``TOPN`` float32 values and int64
indices a row (the counter ``sketch_rows``, the sum of n).  A call of at
most 20 rows writes fewer (n - 1 a row); it is counted at 20, a bound on
the bytes term that never decides: at n = 10,000 the bytes take 6.8 us
and the operations 0.768 ms.

At n = 10,000 and 1,980 MHz the bound is 10,000 x 9,999 / 2 x 514 / (132 x
128 x 1.98e9) s = 0.768 ms.
"""
from __future__ import annotations

SMS = 132
FP32_LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12
DIM = 512
OPS_PER_SCORE = DIM + 2
TOPN = 20
BYTES_PER_ROW = DIM * 4 + 4 + TOPN * (4 + 8)


def sketch_work(score_cells: float, rows: float):
    """(operations, bytes) of sketch calls that weighed ``score_cells``
    distinct scores over ``rows`` rows in all."""
    return float(score_cells) * OPS_PER_SCORE, float(rows) * BYTES_PER_ROW


def bound_s(nbytes: float, ops: float, clock_mhz: float):
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over 3.35 TB/s and the float32 operations over 132 SMs x 128 lanes x
    the SM clock."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": ops / (SMS * FP32_LANES_PER_SM * clock_mhz * 1e6)}
    by = max(terms, key=terms.get)
    return terms[by], by
