"""Plain reference of the sketch retrieval of ``--nontargeted``, for the
benchmark.

A copy of ``isocon_tpu_torch/graph/sketch_reference.py``, so that the
benchmark imports nothing of the program; the one difference is its DP,
which is ``reference.py``'s (``nw_distances`` below), the ``correct``
comparison's own.  ``portbench/tests/test_portbench_nontargeted.py``
holds the two equal on a seeded case.

Written from the method's published description (the docstring of
``graph/sketch.py``, after upstream IsoCon's minimap path, whose heap key
is the shared-k-mer estimate less the length difference), in plain
``torch`` and float64.  It imports nothing of this package and no JAX, so
that it can judge the port on any device, the card included.

* Profiles: each sequence's overlapping 8-mers, as base-5 keys of its
  letter codes (A 0, C 1, G 2, T 3, N 5, any other letter 4, either
  case), each key hashed by the multiply-shift hash
  ``h = key * 0x9E3779B97F4A7C15 mod 2**64`` into the bucket
  ``(h >> 40) mod 512``, counted.  The product wraps in int64 and the
  shift is masked (bits 40-48 of h), so no unsigned type is needed; a
  sequence shorter than 8 has the zero profile.
* Scores: ``sqrt(p_i) . sqrt(p_j) - |len_i - len_j|``, the diagonal
  excluded (-inf); the dot summed over the buckets in their order, so
  that equal profiles give equal scores.
* Each row's top N (``min(N, n - 1)``): by score descending, then index
  ascending.
* The approximate NN graph: exact unit-cost (NW) distances of each
  unconverged row's candidates by a plain DP; per query the candidates at
  its least distance (distances outside (edge_min, edge_max] dropped);
  each such edge inserted both ways, the reverse only into an
  unconverged row and only where that row does not hold it yet.

Where it departs from K6 (``csrc/sketch.cu``): the square roots, the sums
and the subtraction are float64, where K6 takes float32 square roots,
sums each entry as one in-order chain of float32 ``fmaf`` over the 512
buckets and subtracts in float32.  So the port's scores may differ from
these by at most ``score_bound`` (beta), and its lists are judged by
``check_rows``: valid where they are a top N under scores that far off.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import reference

KMER = 8
DIM = 512
TOPN = 20
HASH = 0x9E3779B97F4A7C15 - 2 ** 64     # the constant as a signed int64
SHIFT = 40
UNIT = 2.0 ** -24                        # float32's unit roundoff
# one byte -> letter code (A 0, C 1, G 2, T 3, N 5, anything else 4)
CODES = np.full(256, 4, dtype=np.int64)
for _c, _v in zip("ACGTN", (0, 1, 2, 3, 5)):
    CODES[ord(_c)] = CODES[ord(_c.lower())] = _v


def profiles(seqs: Sequence[str], device=None) -> torch.Tensor:
    """float64 [n, DIM]: the hashed 8-mer counts of each sequence."""
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    total = int(lens.sum())
    out = torch.zeros(n * DIM, dtype=torch.float64, device=device)
    if total < KMER:
        return out.reshape(n, DIM)
    raw = np.frombuffer("".join(seqs).encode("latin1"), dtype=np.uint8)
    flat = torch.from_numpy(CODES[raw]).to(device)
    # a key at every position of the concatenation; those whose window
    # runs past its own sequence's end are dropped
    width = total - KMER + 1
    keys = torch.zeros(width, dtype=torch.int64, device=device)
    for t in range(KMER):
        keys = keys * 5 + flat[t:t + width]
    ends = torch.from_numpy(np.cumsum(lens)).to(device)
    pos = torch.arange(width, device=device)
    row = torch.searchsorted(ends, pos, right=True)
    keep = pos + KMER <= ends[row]
    bucket = ((keys[keep] * HASH) >> SHIFT) & (DIM - 1)
    out += torch.bincount(row[keep] * DIM + bucket,
                          minlength=n * DIM).to(torch.float64)
    return out.reshape(n, DIM)


def square_roots(prof: torch.Tensor) -> torch.Tensor:
    """float64 square roots of the counts ``prof``, each correctly rounded
    (Python's ``math.sqrt``, by table: ``torch.sqrt`` of float64 on the CPU
    is not always the correctly rounded root)."""
    top = int(prof.max()) if prof.numel() else 0
    table = torch.tensor([math.sqrt(c) for c in range(top + 1)],
                         dtype=torch.float64, device=prof.device)
    return table[prof.to(torch.int64)]


def scores(prof: torch.Tensor, lens, rows=None):
    """(score, dot, ldiff), float64 [len(rows), n] each, for the rows
    ``rows`` (default all) against every sequence: the score with the
    diagonal at -inf, the sum of sqrt(p_i) sqrt(p_j) and |len_i - len_j|."""
    n = prof.shape[0]
    dev = prof.device
    rows = (torch.arange(n, device=dev) if rows is None
            else torch.as_tensor(rows, dtype=torch.int64, device=dev))
    lens = torch.as_tensor(lens, dtype=torch.int64, device=dev)
    root = square_roots(prof)
    # summed over the buckets in order, so that an entry depends only on
    # its two profiles (a library product may order the sum by position)
    a, bt = root[rows], root.t().contiguous()
    dot = torch.zeros((rows.numel(), n), dtype=torch.float64, device=dev)
    for d in range(prof.shape[1]):
        dot += a[:, d:d + 1] * bt[d]
    ldiff = (lens[rows, None] - lens[None, :]).abs().to(torch.float64)
    score = dot - ldiff
    score[torch.arange(rows.numel(), device=dev), rows] = float("-inf")
    return score, dot, ldiff


def score_bound(dot: torch.Tensor, ldiff: torch.Tensor) -> torch.Tensor:
    """beta, float64: how far a K6 score may lie from the float64 one.
    The D-step float32 fmaf chain errs by at most D u sum|sqrt(p_i)
    sqrt(p_j)| (u = 2^-24; every term is >= 0, so each partial sum is at
    most the whole); the two float32 square roots of a term add 2 u of it,
    and the float32 subtraction u of |score|.  Written as gamma_(D + 3)
    (dot + ldiff), gamma_m = m u / (1 - m u), which also covers the
    products of these errors."""
    m = DIM + 3
    return (m * UNIT / (1 - m * UNIT)) * (dot + ldiff)


def top_n(score: torch.Tensor, k: int):
    """(values, indices) float64 and int64 [rows, k]: each row's k best,
    by score descending, then index ascending."""
    vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def matches(seqs: Sequence[str], topn: int = TOPN,
            device=None) -> List[List[int]]:
    """Each sequence's top ``min(topn, n - 1)`` indices."""
    n = len(seqs)
    if n <= 1:
        return [[] for _ in seqs]
    prof = profiles(seqs, device)
    score, _dot, _ld = scores(prof, [len(s) for s in seqs])
    return top_n(score, min(topn, n - 1))[1].cpu().tolist()


def check_rows(prof: torch.Tensor, lens, rows, got_idx, got_vals=None,
               topn: int = TOPN) -> Dict[str, float]:
    """The port's lists (int [len(rows), k]) and, where given, their
    scores (float32 [len(rows), k]) for ``rows``, judged against this
    reference.  A list is valid when it holds k distinct indices other
    than its own row, each scoring at least t - 2 beta, and holds every
    index scoring above t + 2 beta: t the row's k-th best score here and
    beta the row's widest ``score_bound``.  (Any scores off by at most
    beta each give a k-th best within beta of t, so their top k lies in
    that band.)  A returned score is within its pair's beta of the
    float64 score, or it is counted outside.  Returns {"rows",
    "lists_invalid", "scores_outside", "worst_score_ratio"}: the worst
    |returned - float64| / beta."""
    n = prof.shape[0]
    k = min(topn, n - 1)
    score, dot, ldiff = scores(prof, lens, rows)
    dev = score.device
    R = score.shape[0]
    rows_t = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    got = torch.as_tensor(np.asarray(got_idx), dtype=torch.int64,
                          device=dev).reshape(R, -1)
    out = {"rows": R, "lists_invalid": R, "scores_outside": 0,
           "worst_score_ratio": 0.0}
    if got.shape[1] != k:
        return out
    beta = score_bound(dot, ldiff)
    beta[torch.arange(R, device=dev), rows_t] = 0.0
    wide = beta.max(dim=1).values
    t = top_n(score, k)[0][:, -1]
    bad = torch.zeros(R, dtype=torch.bool, device=dev)
    inside = (got >= 0) & (got < n)
    gotc = got.clamp(0, n - 1)
    srt = torch.sort(gotc, dim=1).values
    bad |= ~inside.all(dim=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    bad |= (gotc == rows_t[:, None]).any(dim=1)
    got_score = score.gather(1, gotc)
    bad |= (got_score < (t - 2 * wide)[:, None]).any(dim=1)
    listed = torch.zeros_like(score, dtype=torch.bool)
    listed.scatter_(1, gotc, True)
    bad |= ((score > (t + 2 * wide)[:, None]) & ~listed).any(dim=1)
    out["lists_invalid"] = int(bad.sum())
    if got_vals is not None:
        vals = torch.as_tensor(np.asarray(got_vals), device=dev).to(
            torch.float64).reshape(R, -1)[:, :k]
        off = (vals - got_score).abs()
        lim = beta.gather(1, gotc)
        out["scores_outside"] = int((off > lim).sum())
        ratio = torch.where(lim > 0, off / lim,
                            torch.where(off > 0, float("inf"), 0.0))
        out["worst_score_ratio"] = float(ratio.max()) if ratio.numel() \
            else 0.0
    return out


def nw_distances(pairs: Sequence[Tuple[str, str]], device=None) -> np.ndarray:
    """Exact unit-cost global edit distance of each (a, b), int64:
    ``reference.edit_distances`` (NW), the textbook DP one row at a time
    over a batch of pairs."""
    if not pairs:
        return np.zeros(0, dtype=np.int64)
    return reference.edit_distances(pairs, False,
                                    device or torch.device("cpu"))[0]


def nn_graph(seqs: Sequence[str], converged: Sequence[bool],
             topn: int = TOPN, cands: Optional[List[List[int]]] = None,
             edge_min: int = -1, edge_max: int = 2 ** 30,
             device=None) -> List[Dict[int, int]]:
    """The approximate NN graph of ``seqs``: {neighbour: distance} a row.
    ``cands``: the candidate lists (default this reference's
    ``matches``)."""
    n = len(seqs)
    if cands is None:
        cands = matches(seqs, topn, device)
    keys = [(i, j) for i in range(n) if not converged[i] for j in cands[i]]
    dist = nw_distances([(seqs[i], seqs[j]) for i, j in keys], device)
    per_query: Dict[int, Dict[int, int]] = {}
    for (i, j), d in zip(keys, dist.tolist()):
        if edge_min < d <= edge_max:
            per_query.setdefault(i, {})[j] = d
    best: List[Dict[int, int]] = [dict() for _ in range(n)]
    for i, ds in per_query.items():
        least = min(ds.values())
        for j, d in ds.items():
            if d == least:
                best[i][j] = d
                if not converged[j]:
                    best[j].setdefault(i, d)
    return best
