"""Approximate candidate retrieval via hashed k-mer profiles (``--nontargeted``).

Counterpart of ``isocon_tpu/graph/sketch.py``, the equivalent of the
reference's dormant minimap path (``minimap_alignment_module.py:146-269``
+ ``get_best_alignments.py:5-119``, reachable only through
``graphs.construct_approximate_nearest_neighbor_graph:85-149``): every
sequence becomes a hashed k-mer count profile (on the card K7 builds every
read's square-rooted profile from the reads' bytes in one launch), each
read's ``TOPN`` best sketch scores (shared-k-mer estimate minus the length
difference, minimap's heap key) name its candidates (``ops/sketch.py``; on
the card K6 selects them as it scores, and the [N, N] scores are never
stored),
and the candidates get exact distances from the engine, keeping only the
minima per query.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.encode import encode_seq
from ..ops.engine import resolve_device
from ..ops.sketch import DIM, KMER, kmer_profiles, topn_indices
from ..parallel import sharding

TOPN = 20  # matches minimap_alignment_module.py:52 (top-20 heap)


def kmer_profile(seq: str, dim: int = DIM, k: int = KMER) -> np.ndarray:
    """Hashed k-mer count vector (float32 [dim]), one read at a time: the
    JAX package's function, kept as the oracle of ``kmer_profiles``."""
    codes = encode_seq(seq).astype(np.int64)
    if len(codes) < k:
        return np.zeros(dim, dtype=np.float32)
    # pack k consecutive 2-bit-ish codes into an integer key
    keys = np.zeros(len(codes) - k + 1, dtype=np.int64)
    for i in range(k):
        keys = keys * 5 + codes[i : len(codes) - k + 1 + i]
    # multiply-shift hash into dim buckets (uint64 wrap-around arithmetic)
    with np.errstate(over="ignore"):
        h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    buckets = ((h >> np.uint64(40)) % np.uint64(dim)).astype(np.int64)
    prof = np.zeros(dim, dtype=np.float32)
    np.add.at(prof, buckets, 1.0)
    return prof


def approximate_matches(seqs: Sequence[str], topn: int = TOPN,
                        device=None, counters=None) -> List[List[int]]:
    """Per sequence, the indices of its topn sketch-similar neighbors,
    scored on ``device`` (default CUDA; ``"cpu"`` runs the plain
    versions).  The reads' bytes and offsets go to the device in one
    pinned copy each, and ``kmer_profiles`` (K7 on a card) writes the
    square-rooted profiles there, which K6 reads.  ``counters`` (an
    engine's): the host seconds of the profiles (the join, the uploads and
    the launch, with no wait for the card) add to its
    ``sketch_profile_seconds``, the bytes sent to ``upload_bytes``, and on
    a card the rows to ``sketch_profile_card_rows``."""
    n = len(seqs)
    if n <= 1:
        return [[] for _ in seqs]
    dev = resolve_device(device)
    t0 = time.perf_counter()
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, seqs), dtype=np.int64, count=n),
              out=offsets[1:])
    raw = np.frombuffer(bytearray("".join(seqs), "ascii"), dtype=np.uint8)
    off_d = sharding.upload(offsets, dev)
    roots = kmer_profiles(sharding.upload(raw, dev), off_d)
    if counters is not None:
        counters["sketch_profile_seconds"] += time.perf_counter() - t0
        counters["upload_bytes"] += raw.nbytes + offsets.nbytes
        if dev.type == "cuda":
            counters["sketch_profile_card_rows"] += n
    k = min(topn, n - 1)
    idx = topn_indices(roots, torch.diff(off_d).to(torch.int32), k)
    return idx.cpu().tolist()


def approximate_nn_graph(
    unique_seqs: Sequence[str],
    converged: Sequence[bool],
    engine,
    topn: int = TOPN,
    edge_min_threshold: int = -1,
    edge_max_threshold: int = 2 ** 30,
) -> List[Dict[int, int]]:
    """Approximate min-ED neighbor sets: sketch retrieval + exact rescoring.

    Same output shape as ``graph.nn.nearest_neighbors``; edges outside
    (edge_min_threshold, edge_max_threshold) are dropped and edges are
    inserted symmetrically, mirroring ``get_best_alignments.py:22-45``.
    The sketch runs on the engine's device, inside the profiler span
    ``isocon_phase1.sketch`` (the bytes' upload, K7, K6, fetch); its rows,
    seconds, profile seconds and distinct scores (n(n - 1)/2: a score is
    symmetric in its two rows) add to the engine's ``sketch_rows``,
    ``sketch_seconds``, ``sketch_profile_seconds`` and
    ``sketch_score_cells``, the rows K7 built to
    ``sketch_profile_card_rows``, the rescoring pairs to ``sketch_pairs``.
    """
    n = len(unique_seqs)
    t0 = time.perf_counter()
    with record_function("isocon_phase1.sketch"):
        cands = approximate_matches(unique_seqs, topn, device=engine.device,
                                    counters=engine.counters)
    engine.counters["sketch_rows"] += n
    engine.counters["sketch_seconds"] += time.perf_counter() - t0
    engine.counters["sketch_score_cells"] += n * (n - 1) // 2
    ids = engine.add_seqs(unique_seqs)
    keys = []
    for i in range(n):
        if converged[i]:
            continue
        for j in cands[i]:
            keys.append((i, j))
    karr = (np.asarray(keys, dtype=np.int64).reshape(-1, 2)
            if keys else np.empty((0, 2), dtype=np.int64))
    engine.counters["sketch_pairs"] += len(keys)
    eds, _ = engine.edit_distances_idx(ids[karr[:, 0]], ids[karr[:, 1]])

    best: List[Dict[int, int]] = [dict() for _ in range(n)]
    per_query: Dict[int, Dict[int, int]] = {}
    for (i, j), d in zip(keys, eds):
        if d <= edge_min_threshold or d > edge_max_threshold or d < 0:
            continue
        per_query.setdefault(i, {})[j] = int(d)
    for i, ds in per_query.items():
        if not ds:
            continue
        m = min(ds.values())
        for j, d in ds.items():
            if d == m:
                best[i][j] = d
                # symmetric insertion (get_best_alignments.py:27-33 inserts
                # the reverse edge when absent)
                if not converged[j]:
                    best[j].setdefault(i, d)
    return best
