"""Plain reference for the benchmark's ``correct`` comparison.

Plain PyTorch (on the card after the window, or on the CPU in the tests)
and Python; it imports nothing of the program and takes nothing the
program made but the answers it judges.  Its dynamic programmes are the
textbook ones, one DP row at a time over a batch of pairs:

* unit-cost edit distance, global (NW) and infix (HW: the query whole,
  the target's flanks free): D[i][j] = min(D[i-1][j-1] + (a_i != b_j),
  D[i-1][j] + 1, D[i][j-1] + 1), with D[0][j] = j (NW) or 0 (HW) and
  D[i][0] = i.  The row's horizontal chain is a prefix minimum:
  D[i][j] - j = min(D[i][0], min_{k<=j} (T[k] - k)), T the row without it.
* affine semi-global alignment score (parasail's ``sg``: end gaps free in
  both sequences, a gap of length k costs open + (k - 1) ext): Gotoh's
  H, E, F with H = 0 on row 0 and column 0, the answer the best H on the
  last row or the last column.  With open >= ext, the row's horizontal
  gaps are a prefix maximum of G[k] + k ext, G the row without them.

``alignment_score`` scores an alignment given as two gapped strings by
the same rules, so that an answer is judged by what it says: the program
may break ties another way than the reference.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

BIG = 1 << 29          # "infinity" of the int32 rows
# elements of one [pairs, columns] row tensor of a block
BLOCK_ELEMENTS = 1 << 25


def _codes(seqs: Sequence[str], width: int, fill: int) -> np.ndarray:
    out = np.full((len(seqs), width), fill, dtype=np.uint8)
    for r, s in enumerate(seqs):
        out[r, :len(s)] = np.frombuffer(s.encode("latin1"), dtype=np.uint8)
    return out


def _blocks(lens_a: np.ndarray, lens_b: np.ndarray):
    """Index blocks of pairs of similar query length whose rows fit
    BLOCK_ELEMENTS, the longest query first."""
    order = np.argsort(-lens_a, kind="stable")
    i = 0
    while i < order.size:
        width = int(lens_b[order[i:]].max()) + 1
        per = max(1, BLOCK_ELEMENTS // width)
        yield order[i:i + per]
        i += per


def edit_distances(pairs: Sequence[Tuple[str, str]], hw: bool,
                   device) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Exact unit edit distance of each (a, b): NW, or HW (a inside b).
    Returns (distance int64 [P], for HW each pair's last DP row
    D[len(a)][0..len(b)] as int32, empty for NW)."""
    P = len(pairs)
    la = np.fromiter((len(a) for a, _ in pairs), dtype=np.int64, count=P)
    lb = np.fromiter((len(b) for _, b in pairs), dtype=np.int64, count=P)
    dist = np.zeros(P, dtype=np.int64)
    last_rows: List[np.ndarray] = [np.zeros(0, dtype=np.int32)] * P
    for idx in _blocks(la, lb):
        n_max = int(la[idx].max())
        m_max = int(lb[idx].max())
        qa = torch.from_numpy(_codes([pairs[k][0] for k in idx], n_max, 0))
        tb = torch.from_numpy(_codes([pairs[k][1] for k in idx], m_max, 1))
        qa, tb = qa.to(device), tb.to(device)
        n = torch.from_numpy(la[idx]).to(device)
        m = torch.from_numpy(lb[idx]).to(device)
        B = len(idx)
        cols = torch.arange(m_max + 1, device=device, dtype=torch.int32)
        if hw:
            row = torch.zeros((B, m_max + 1), dtype=torch.int32,
                              device=device)
        else:
            row = cols.expand(B, m_max + 1).clone()
        last = torch.zeros((B, m_max + 1), dtype=torch.int32, device=device)
        ends = set(la[idx].tolist())
        if 0 in ends:
            last[n == 0] = row[n == 0]
        for i in range(1, n_max + 1):
            neq = (tb != qa[:, i - 1:i]).to(torch.int32)
            t = torch.minimum(row[:, :-1] + neq, row[:, 1:] + 1)
            f = torch.cummin(t - cols[1:], dim=1).values
            f = torch.clamp(f, max=i)
            row = torch.cat([torch.full((B, 1), i, dtype=torch.int32,
                                        device=device), f + cols[1:]], dim=1)
            if i in ends:
                at = n == i
                last[at] = row[at]
        if hw:
            masked = torch.where(cols[None, :] <= m[:, None], last,
                                 torch.full_like(last, BIG))
            found = masked.min(dim=1).values
            rows_np = last.cpu().numpy()
            for r, k in enumerate(idx.tolist()):
                last_rows[k] = rows_np[r, :lb[k] + 1].copy()
        else:
            found = last.gather(1, m[:, None]).squeeze(1)
        dist[idx] = found.cpu().numpy()
    return dist, last_rows


def semi_global_scores(pairs: Sequence[Tuple[str, str]],
                       scores: Sequence[Tuple[int, int, int, int]],
                       device) -> np.ndarray:
    """Optimal affine semi-global score of each (a, b) under its
    (match, mismatch, open, ext), mismatch as a negative score and open,
    ext as positive penalties; open >= ext."""
    P = len(pairs)
    la = np.fromiter((len(a) for a, _ in pairs), dtype=np.int64, count=P)
    lb = np.fromiter((len(b) for _, b in pairs), dtype=np.int64, count=P)
    sc = np.asarray(scores, dtype=np.int64).reshape(P, 4)
    sc[:, 1] = -np.abs(sc[:, 1])
    if (sc[:, 2] < sc[:, 3]).any():
        raise ValueError("the prefix-maximum form needs open >= ext")
    best = np.zeros(P, dtype=np.int64)
    for idx in _blocks(la, lb):
        n_max = int(la[idx].max())
        m_max = int(lb[idx].max())
        qa = torch.from_numpy(_codes([pairs[k][0] for k in idx], n_max, 0))
        tb = torch.from_numpy(_codes([pairs[k][1] for k in idx], m_max, 1))
        qa, tb = qa.to(device), tb.to(device)
        n = torch.from_numpy(la[idx]).to(device)
        m = torch.from_numpy(lb[idx]).to(device)
        s = torch.from_numpy(sc[idx].astype(np.int32)).to(device)
        ma, mi, go, ge = (s[:, c:c + 1] for c in range(4))
        B = len(idx)
        cols = torch.arange(m_max + 1, device=device, dtype=torch.int32)
        neg = torch.full((B, m_max + 1), -BIG, dtype=torch.int32,
                         device=device)
        H = torch.zeros((B, m_max + 1), dtype=torch.int32, device=device)
        F = neg.clone()
        in_col = cols[None, :] <= m[:, None]
        # best H on column m over the rows so far, and on row n
        col_best = torch.zeros(B, dtype=torch.int32, device=device)
        row_best = torch.full((B,), -BIG, dtype=torch.int32, device=device)
        mcol = m[:, None]
        zero = torch.zeros((B, 1), dtype=torch.int32, device=device)
        ends = set(la[idx].tolist())
        for i in range(1, n_max + 1):
            F = torch.maximum(F - ge, H - go)
            sub = torch.where(tb == qa[:, i - 1:i], ma, mi)
            G = torch.cat([zero, torch.maximum(H[:, :-1] + sub, F[:, 1:])],
                          dim=1)
            run = torch.cummax(G + cols * ge, dim=1).values
            E = torch.cat([neg[:, :1], run[:, :-1] - go - cols[:-1] * ge],
                          dim=1)
            H = torch.maximum(G, E)
            H[:, 0] = 0
            live = (n >= i)
            col_best = torch.where(
                live, torch.maximum(col_best, H.gather(1, mcol).squeeze(1)),
                col_best)
            if i in ends:
                at = n == i
                rb = torch.where(in_col, H, torch.full_like(H, -BIG))
                row_best = torch.where(at, rb.max(dim=1).values, row_best)
        done0 = n == 0
        row_best = torch.where(done0, torch.zeros_like(row_best), row_best)
        best[idx] = torch.maximum(col_best, row_best).cpu().numpy()
    return best


def alignment_score(a1: str, a2: str, q: str, t: str,
                    score: Tuple[int, int, int, int]):
    """(score, (matches, mismatches, indels)) of the alignment (a1, a2) of
    q and t under parasail's ``sg`` rules, or None when (a1, a2) is not an
    alignment of q and t.  A gap column is free on the boundary of the DP
    grid: consuming t on row 0 or row len(q), or consuming q on column 0
    or column len(t); any other gap run costs open + (k - 1) ext."""
    ma, mi, go, ge = score
    mi = -abs(mi)
    if (len(a1) != len(a2) or a1.replace("-", "") != q
            or a2.replace("-", "") != t):
        return None
    n, m = len(q), len(t)
    i = j = 0
    total = matches = mismatches = 0
    prev = None          # kind of the previous paid gap column
    for c1, c2 in zip(a1, a2):
        if c1 == "-" and c2 == "-":
            return None
        if c1 != "-" and c2 != "-":
            if c1 == c2:
                total += ma
                matches += 1
            else:
                total += mi
                mismatches += 1
            i += 1
            j += 1
            prev = None
            continue
        kind = "t" if c1 == "-" else "q"
        free = (i in (0, n)) if kind == "t" else (j in (0, m))
        if not free:
            total -= ge if prev == kind else go
            prev = kind
        else:
            prev = None
        if kind == "t":
            j += 1
        else:
            i += 1
    return total, (matches, mismatches, len(a1) - matches - mismatches)
