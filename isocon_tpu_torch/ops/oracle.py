"""Reference DP implementations (numpy, O(n*m)).

These are the ground truth the batched DP kernels are tested against, and
double as a host fallback for tiny problems.  They pin down the exact
semantics the rebuild uses:

* ``edit_distance``      — unit-cost global (NW) Levenshtein distance, the
  quantity the reference obtains from edlib ``mode="NW", task="distance"``
  (``edlib_alignment_module.py:111``, ``nearest_neighbor_graph.py:104-107``).
* ``edit_distance_hw``   — infix mode: target flanks are gap-free, query is
  fully consumed (edlib ``mode="HW"``, used by the ends-ignored candidate
  graph, ``end_invariant_functions.py:593-621``).  Returns distance, target
  start/end of the alignment and the op string.
* ``align_semi_global``  — affine-gap semi-global alignment with traceback
  (parasail ``sg_trace_scan_16`` semantics: end gaps free in BOTH sequences,
  gap of length k costs open + (k-1)*ext; ``SW_alignment_module.py:64-86``).

Tie-breaking is pinned here (and mirrored by the kernels):
  * score ties at a cell prefer diagonal, then the gap consuming the target
    (s2), then the gap consuming the query (s1);
  * affine gap-state ties prefer opening over extending;
  * the semi-global endpoint maximizes score, ties prefer larger i, then
    larger j (i indexes s1, j indexes s2).
The reference's exact choices are an edlib/parasail implementation detail;
what must match is the *decision level* downstream (SURVEY.md section 7).
"""
from __future__ import annotations

import numpy as np

NEG = -(10 ** 9)


def edit_distance(a: str, b: str, k: int | None = None) -> int:
    """Unit-cost global edit distance; if k is given and d > k, returns -1
    (mirroring edlib's cutoff contract)."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        d = max(n, m)
        return d if (k is None or d <= k) else -1
    ea = np.frombuffer(a.encode(), dtype=np.uint8)
    eb = np.frombuffer(b.encode(), dtype=np.uint8)
    prev = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int32)
        cur[0] = i
        sub = prev[:-1] + (ea[i - 1] != eb)
        dele = prev[1:] + 1
        t = np.minimum(sub, dele)
        # horizontal (insertion) chain: cur[j] = min(t[j-1], cur[j-1]+1)
        # resolved with the classic min-plus prefix scan
        f = t - np.arange(1, m + 1)
        np.minimum.accumulate(f, out=f)
        cur[1:] = np.minimum(t, f + np.arange(1, m + 1))
        # the prefix scan above misses chains rooted at cur[0]; fold it in
        chain0 = i + np.arange(1, m + 1)
        cur[1:] = np.minimum(cur[1:], chain0)
        prev = cur
    d = int(prev[m])
    if k is not None and d > k:
        return -1
    return d


def _unit_dp_matrix(a: str, b: str, free_b_start: bool) -> np.ndarray:
    n, m = len(a), len(b)
    D = np.zeros((n + 1, m + 1), dtype=np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = 0 if free_b_start else np.arange(m + 1)
    ea = np.frombuffer(a.encode(), dtype=np.uint8)
    eb = np.frombuffer(b.encode(), dtype=np.uint8)
    for i in range(1, n + 1):
        sub = D[i - 1, :-1] + (ea[i - 1] != eb)
        dele = D[i - 1, 1:] + 1
        t = np.minimum(sub, dele)
        f = t - np.arange(1, m + 1)
        np.minimum.accumulate(f, out=f)
        row = np.minimum(t, f + np.arange(1, m + 1))
        row = np.minimum(row, D[i, 0] + np.arange(1, m + 1))
        D[i, 1:] = row
    return D


def edit_distance_hw(q: str, t: str):
    """Infix (edlib HW) unit edit distance of query q inside target t.

    Returns (ed, start, end, ops) where t[start:end+1] is the aligned target
    span (end inclusive, -1 convention when empty) and ops is a string over
    {'=', 'X', 'I', 'D'} with 'I' consuming only q and 'D' consuming only t
    (edlib cigar convention).  Endpoint ties prefer the smallest end.
    """
    n, m = len(q), len(t)
    D = _unit_dp_matrix(q, t, free_b_start=True)
    ed = int(D[n].min())
    end_j = int(np.argmin(D[n]))  # smallest j among minima
    # traceback from (n, end_j) to row 0; preference: diag > D(t) > I(q)
    i, j = n, end_j
    ops = []
    eq_ = np.frombuffer(q.encode(), dtype=np.uint8)
    et = np.frombuffer(t.encode(), dtype=np.uint8)
    while i > 0:
        if i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] + (eq_[i - 1] != et[j - 1]):
            ops.append("=" if eq_[i - 1] == et[j - 1] else "X")
            i, j = i - 1, j - 1
        elif j > 0 and D[i, j] == D[i, j - 1] + 1:
            ops.append("D")
            j -= 1
        else:
            assert i > 0 and D[i, j] == D[i - 1, j] + 1
            ops.append("I")
            i -= 1
    start_j = j
    ops.reverse()
    return ed, start_j, end_j - 1, "".join(ops)


def nw_unit_alignment(a: str, b: str):
    """Global unit-cost alignment with traceback.

    Returns (ed, ops) with ops over {'=','X','I','D'}; 'I' consumes a, 'D'
    consumes b.  Preference: diag > D > I (pinned).
    """
    n, m = len(a), len(b)
    D = _unit_dp_matrix(a, b, free_b_start=False)
    ea = np.frombuffer(a.encode(), dtype=np.uint8)
    eb = np.frombuffer(b.encode(), dtype=np.uint8)
    i, j = n, m
    ops = []
    while i > 0 or j > 0:
        if i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] + (ea[i - 1] != eb[j - 1]):
            ops.append("=" if ea[i - 1] == eb[j - 1] else "X")
            i, j = i - 1, j - 1
        elif j > 0 and D[i, j] == D[i, j - 1] + 1:
            ops.append("D")
            j -= 1
        else:
            ops.append("I")
            i -= 1
    ops.reverse()
    return int(D[n, m]), "".join(ops)


def align_semi_global(
    s1: str,
    s2: str,
    match_score: int = 2,
    mismatch_penalty: int = -3,
    opening_penalty: int = 2,
    gap_ext: int = 0,
):
    """Affine semi-global alignment of s1 vs s2 with traceback.

    Returns (s1_aligned, s2_aligned, (matches, mismatches, indels)), the
    same triple the reference builds from the parasail cigar
    (``SW_alignment_module.py:78-86``).  A gap run of length k costs
    opening_penalty + (k-1)*gap_ext; end gaps in either sequence are free.
    """
    n, m = len(s1), len(s2)
    if n == 0 or m == 0:
        a1 = s1 + "-" * m
        a2 = "-" * n + s2
        return a1, a2, (0, 0, n + m)
    e1 = np.frombuffer(s1.encode(), dtype=np.uint8)
    e2 = np.frombuffer(s2.encode(), dtype=np.uint8)
    H = np.full((n + 1, m + 1), 0, dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # gap consuming s2
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # gap consuming s1
    for i in range(1, n + 1):
        sub = np.where(e1[i - 1] == e2, match_score, mismatch_penalty)
        # E along the row has a horizontal chain; with integer scores do it
        # sequentially in a vector-free loop only for E. Use iterative scan:
        Hrow_prev = H[i - 1]
        F[i, 1:] = np.maximum(Hrow_prev[1:] - opening_penalty, F[i - 1, 1:] - gap_ext)
        # left-to-right for H and E jointly
        hrow = H[i]
        erow = E[i]
        frow = F[i]
        hl = hrow[0]
        el = NEG
        for j in range(1, m + 1):
            e = max(hl - opening_penalty, el - gap_ext)
            h = max(Hrow_prev[j - 1] + sub[j - 1], e, frow[j])
            erow[j] = e
            hrow[j] = h
            hl = h
            el = e
    # endpoint: max over last row/col; ties prefer larger i then larger j
    best = NEG
    bi, bj = 0, 0
    cand = [(i, m) for i in range(n + 1)] + [(n, j) for j in range(m + 1)]
    for (i, j) in cand:
        s = H[i, j]
        if s > best or (s == best and (i > bi or (i == bi and j > bj))):
            best, bi, bj = s, i, j
    # traceback
    a1, a2 = [], []
    i, j = bi, bj
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            s = match_score if e1[i - 1] == e2[j - 1] else mismatch_penalty
            if H[i, j] == H[i - 1, j - 1] + s:
                a1.append(s1[i - 1])
                a2.append(s2[j - 1])
                i, j = i - 1, j - 1
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                assert H[i, j] == F[i, j]
                state = "F"
        elif state == "E":
            a1.append("-")
            a2.append(s2[j - 1])
            opened = H[i, j - 1] - opening_penalty
            if E[i, j] == opened:
                state = "H"
            j -= 1
        else:  # F
            a1.append(s1[i - 1])
            a2.append("-")
            opened = H[i - 1, j] - opening_penalty
            if F[i, j] == opened:
                state = "H"
            i -= 1
    # leading free end gaps
    while i > 0:
        a1.append(s1[i - 1])
        a2.append("-")
        i -= 1
    while j > 0:
        a1.append("-")
        a2.append(s2[j - 1])
        j -= 1
    a1.reverse()
    a2.reverse()
    # trailing free end gaps
    t1 = s1[bi:]
    t2 = s2[bj:]
    a1s = "".join(a1) + t1 + "-" * len(t2)
    a2s = "".join(a2) + "-" * len(t1) + t2
    matches = sum(1 for x, y in zip(a1s, a2s) if x == y and x != "-")
    mismatches = sum(1 for x, y in zip(a1s, a2s) if x != y and x != "-" and y != "-")
    indels = len(a1s) - matches - mismatches
    return a1s, a2s, (matches, mismatches, indels)
