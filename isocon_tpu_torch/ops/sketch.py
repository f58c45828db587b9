"""Sketch scores of the approximate NN graph (K6) and their top-n.

Counterpart of ``isocon_tpu/graph/sketch.py::_topn_scores`` (a ``jax.jit``
of a dot and ``lax.top_k``, not a Pallas kernel).  With p the square roots
of the hashed k-mer counts, float32 [N, D]:

    score[i, j] = sum_d p[i, d] * p[j, d]  -  float(|len_i - len_j|)
                  (- 1e9 where i == j)

The sum decides which neighbours a read gets, so its float32 rounding is
part of the result.  It is fixed here as one chain of exact float32 fused
multiply-adds per entry, ``acc = fmaf(p[i, d], p[j, d], acc)`` for
d = 0 .. D-1 from 0.0: the order XLA:CPU's dot takes at up to 3,000 rows
(the JAX package leaves it to its backend; at 10,000 rows XLA:CPU blocks
the sum otherwise).  A library matrix product gives no such order (split
sums, TF32 or tensor-core accumulation), so it is not used.  Then the
length difference and the diagonal's 1e9 are subtracted, each a rounded
float32 subtraction, as the JAX function does.

Each row's k best scores, in ``topn``'s order (descending, the lower index
first among equal values, as ``lax.top_k`` gives them; the graph inserts
edges in that order), are ``topn_scores``.  For CUDA tensors it is two
kernels of ``csrc/sketch.cu`` over all N rows at once, and the [N, N]
scores never exist: ``sketch_topn`` keeps each row's k best of each of a
few column segments (``plan_segments``, ``segment_bounds``), and
``merge_topn`` merges a row's lists.  For CPU tensors it scores
``ROW_CHUNK`` rows at a time with ``sketch_scores_plain`` and sorts them
(``topn``).  ``sketch_scores`` (the same tile kernel storing every score)
is for checking the chain on every entry; the main path does not call it.
Beside each kernel is its plain version: ``sketch_scores_plain``,
``sketch_topn_plain`` (``segment_topn_plain`` of the plain scores) and
``merge_topn_plain``.

p itself, the square roots of each read's hashed 8-mer counts, is
``kmer_profiles`` of the reads' bytes: K7 (``csrc/sketch.cu``, launch
counter ``kmer_profile``) for CUDA tensors, ``kmer_profiles_plain`` for CPU
tensors; both equal ``np.sqrt`` of the stacked
``graph/sketch.py::kmer_profile`` rows bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .encode import encode_bytes

ROW_CHUNK = 4096
DIAG_PENALTY = 1e9
TILE = 128            # csrc/sketch.cu's kTile: rows and columns of a tile
MAX_K = 32            # its kSlots: a row's list, one slot a lane
MAX_SEGMENTS = 32     # the merge kernel holds a row's lists one a lane
# the first pass's plan (``plan_segments``): what a segment's first tile
# adds in tile times (all its columns pass the threshold and are sorted
# into the lists), and the share of an SM's throughput with two resident
# blocks (98 KB of shared memory and at most 128 registers a thread each)
# that one block alone gets, an estimate
SEGMENT_START_TILES = 0.5
LONE_BLOCK_RATE = 0.9
PAD_INDEX = 2 ** 31 - 1   # the column of a pad, whose score is -inf
# the profiles (K7: csrc/sketch.cu's kKmer, kProfileDim, kKmerHash): k-mers
# of KMER letters, hashed into DIM buckets by the top bits of a
# multiplicative hash
KMER = 8
DIM = 512
KMER_HASH = 0x9E3779B97F4A7C15
HASH_SHIFT = 40


def fmaf_plain(acc: torch.Tensor, prod: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, acc) of float32 values held in float64, given the exact
    product ``prod`` = a * b (float64 holds 24 + 24 bits exactly).

    ``acc + prod`` in float64 and then float32 would round twice, which is
    wrong where the float64 sum lands on a float32 midpoint.  So the float64
    sum is rounded to odd (Boldo and Melquiond): TwoSum gives the exact
    error of ``acc + prod``; where it is not 0 and the sum is even, the sum
    moves one ulp toward the error.  A rounded-to-odd float64 rounds to the
    correctly rounded float32 (53 >= 24 + 2 bits).  Returns float64 holding
    the float32 result."""
    s = acc + prod
    bb = s - acc
    err = (acc - (s - bb)).add_(prod - bb)
    # round to odd = the sum truncated toward zero, its last bit set where
    # it was inexact; the truncation is one ulp below |s| where the error
    # points toward zero
    bits = s.view(torch.int64)
    bits -= (err * s < 0).to(torch.int64)
    bits |= (err != 0).to(torch.int64)
    return s.to(torch.float32).to(torch.float64)


def sketch_scores_plain(prof_sqrt: torch.Tensor, lens: torch.Tensor,
                        row0: int, rows: int) -> torch.Tensor:
    """Plain PyTorch version of K6: float32 [rows, N] scores of rows
    row0 .. row0 + rows - 1 against all N, each entry's sum one in-order
    chain of ``fmaf_plain`` steps over d."""
    p = prof_sqrt.to(torch.float64)
    a = p[row0:row0 + rows]
    bt = p.t().contiguous()
    acc = torch.zeros((a.shape[0], p.shape[0]), dtype=torch.float64,
                      device=p.device)
    for d in range(p.shape[1]):
        acc = fmaf_plain(acc, a[:, d:d + 1] * bt[d])
    lens = lens.to(torch.int64)
    ldiff = (lens[row0:row0 + rows, None] - lens[None, :]).abs()
    scores = acc.to(torch.float32) - ldiff.to(torch.float32)
    i = torch.arange(scores.shape[0], device=p.device)
    scores[i, i + row0] -= DIAG_PENALTY
    return scores


def sketch_scores(prof_sqrt: torch.Tensor, lens: torch.Tensor, row0: int,
                  rows: int) -> torch.Tensor:
    """Scores of rows row0 .. row0 + rows - 1 (float32 [rows, N]) of the
    square-rooted profiles ``prof_sqrt`` (float32 [N, D]) and lengths
    ``lens`` (int [N]): the scores entry of K6 for CUDA tensors, the plain
    version for CPU tensors."""
    if prof_sqrt.device.type == "cpu":
        return sketch_scores_plain(prof_sqrt, lens, row0, rows)
    return _scores_cuda(prof_sqrt, lens, row0, rows)


def _check_inputs(prof_sqrt, lens):
    if lens.device != prof_sqrt.device:
        raise ValueError("sketch inputs on mixed devices")
    if prof_sqrt.dtype != torch.float32 or prof_sqrt.dim() != 2:
        raise TypeError("prof_sqrt must be float32 [N, D]")
    N, D = prof_sqrt.shape
    if lens.shape != (N,):
        raise ValueError("lens must be [N], got %s" % (tuple(lens.shape),))
    if D % 32 or D == 0:
        raise ValueError("K6 takes D a multiple of 32, got %d" % D)
    return N, D


def _transposed(p):
    """float32 [D, ld]: p (float32 [n, D]) transposed, zero-padded to ld, a
    multiple of ``TILE`` columns (the kernel's copies need no bounds)."""
    n, D = p.shape
    ld = max(1, -(-n // TILE)) * TILE
    pt = torch.zeros((D, ld), dtype=torch.float32, device=p.device)
    pt[:, :n] = p.t()
    return pt, ld


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _scores_cuda(prof_sqrt, lens, row0, rows):
    """Launch K6's scores entry; returns float32 [rows, N]."""
    lib = _build.load("sketch")
    N, D = _check_inputs(prof_sqrt, lens)
    if not 0 <= row0 <= row0 + rows <= N:
        raise ValueError("rows %d .. %d outside 0 .. %d"
                         % (row0, row0 + rows, N))
    dev = prof_sqrt.device
    out = torch.empty((rows, N), dtype=torch.float32, device=dev)
    if rows == 0 or N == 0:
        return out
    at, lda = _transposed(prof_sqrt[row0:row0 + rows])
    bt, ldb = _transposed(prof_sqrt)
    ln = lens.to(torch.int32).contiguous()
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        dev, "sketch_scores", lib.isocon_sketch_scores,
        P(at.data_ptr()), P(bt.data_ptr()), P(ln.data_ptr()),
        P(out.data_ptr()), I(N), I(D), I(lda), I(ldb), I(row0), I(rows),
        _stream(dev))
    return out


def topn(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, in
    descending order, the lower index first among equal values."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


# ---------------------------------------------------------------------------
# the fused top-n: segments, the two passes and their plain versions
# ---------------------------------------------------------------------------
def plan_segments(N: int, sms: int) -> int:
    """Column segments of the first pass (1 .. min(ceil(N / TILE), 32)).
    The grid is (segments) x (strips of TILE rows) and a block walks its
    segment's tiles, so the count trades blocks against tiles a block.
    Picks the count with the least ``segment_cost``; the more segments on
    a tie (more SMs busy)."""
    tiles = -(-N // TILE)
    best = None
    for nseg in range(1, max(1, min(tiles, MAX_SEGMENTS)) + 1):
        cost = segment_cost(tiles, nseg, sms)
        if best is None or cost <= best[0]:
            best = (cost, nseg)
    return best[1]


def segment_cost(tiles: int, nseg: int, sms: int) -> float:
    """The first pass's time in tile times, as the plan estimates it: the
    blocks spread evenly over the SMs (two at a time share one's
    throughput), each its longest segment's tiles plus
    ``SEGMENT_START_TILES``; where no SM gets two blocks, a block runs
    alone at ``LONE_BLOCK_RATE`` of an SM's shared throughput."""
    blocks = tiles * nseg
    cost = -(-blocks // sms) * (-(-tiles // nseg) + SEGMENT_START_TILES)
    return cost / LONE_BLOCK_RATE if blocks <= sms else cost


def segment_bounds(N: int, nseg: int):
    """[(first column, end column)] of each segment: tiles of ``TILE``
    columns cut as the kernel cuts them, segment s holding tiles
    tiles * s // nseg .. tiles * (s + 1) // nseg - 1."""
    tiles = -(-N // TILE)
    return [(tiles * s // nseg * TILE, min(N, tiles * (s + 1) // nseg * TILE))
            for s in range(nseg)]


def segment_topn_plain(scores: torch.Tensor, k: int, bounds):
    """Plain version of the first pass from a score matrix [rows, N]: for
    each segment (c0, c1) of ``bounds``, each row's ``topn`` of columns
    c0 .. c1 - 1, padded with (-inf, ``PAD_INDEX``) where the segment has
    fewer than k columns.  Returns float32 and int32 [rows, len(bounds), k]."""
    rows = scores.shape[0]
    vals = torch.full((rows, len(bounds), k), float("-inf"),
                      dtype=torch.float32, device=scores.device)
    idx = torch.full((rows, len(bounds), k), PAD_INDEX, dtype=torch.int32,
                     device=scores.device)
    for s, (c0, c1) in enumerate(bounds):
        v, i = topn(scores[:, c0:c1], k)
        vals[:, s, :v.shape[1]] = v
        idx[:, s, :i.shape[1]] = (i + c0).to(torch.int32)
    return vals, idx


def sketch_topn_plain(prof_sqrt: torch.Tensor, lens: torch.Tensor, k: int,
                      segments: int):
    """Plain version of the first pass: ``segment_topn_plain`` of all N
    rows' plain scores over ``segment_bounds(N, segments)``."""
    N = prof_sqrt.shape[0]
    return segment_topn_plain(sketch_scores_plain(prof_sqrt, lens, 0, N), k,
                              segment_bounds(N, segments))


def merge_topn_plain(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Plain version of the merge: each row's k best of its lists (float32
    and int [rows, S, k], the indices of a row distinct) in ``topn``'s
    order.  Returns float32 and int64 [rows, k]."""
    rows = vals.shape[0]
    v = vals.reshape(rows, -1)
    i = idx.reshape(rows, -1).to(torch.int64)
    order = torch.argsort(i, dim=1, stable=True)
    v, i = v.gather(1, order), i.gather(1, order)
    order = torch.sort(v, dim=1, descending=True, stable=True)[1][:, :k]
    return v.gather(1, order), i.gather(1, order)


def sketch_topn(prof_sqrt: torch.Tensor, lens: torch.Tensor, k: int,
                segments: int):
    """The first pass: each row's k best of each of ``segments`` column
    segments, float32 and int32 [N, segments, k]; the kernel for CUDA
    tensors, ``sketch_topn_plain`` for CPU tensors."""
    if prof_sqrt.device.type == "cpu":
        return sketch_topn_plain(prof_sqrt, lens, k, segments)
    lib = _build.load("sketch")
    N, D = _check_inputs(prof_sqrt, lens)
    tiles = -(-N // TILE)
    if not 1 <= k <= min(MAX_K, max(N - 1, 1)):
        raise ValueError("k %d outside 1 .. min(%d, N - 1)" % (k, MAX_K))
    if not 1 <= segments <= min(tiles, MAX_SEGMENTS):
        raise ValueError("segments %d outside 1 .. min(%d tiles, %d)"
                         % (segments, tiles, MAX_SEGMENTS))
    dev = prof_sqrt.device
    pt, ld = _transposed(prof_sqrt)
    ln = lens.to(torch.int32).contiguous()
    vals = torch.empty((N, segments, k), dtype=torch.float32, device=dev)
    idx = torch.empty((N, segments, k), dtype=torch.int32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        dev, "sketch_topn", lib.isocon_sketch_topn,
        P(pt.data_ptr()), P(ln.data_ptr()), P(vals.data_ptr()),
        P(idx.data_ptr()), I(N), I(D), I(ld), I(k), I(segments),
        _stream(dev))
    return vals, idx


def merge_topn(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The second pass: each row's k best of its lists (float32 and int
    [N, S, k]), float32 and int64 [N, k]; the kernel for CUDA tensors,
    ``merge_topn_plain`` for CPU tensors."""
    if vals.device.type == "cpu":
        return merge_topn_plain(vals, idx, k)
    lib = _build.load("sketch")
    if idx.device != vals.device:
        raise ValueError("merge inputs on mixed devices")
    if vals.dtype != torch.float32 or vals.dim() != 3:
        raise TypeError("vals must be float32 [N, S, k]")
    N, S, kin = vals.shape
    if idx.shape != vals.shape:
        raise ValueError("idx %s != vals %s" % (tuple(idx.shape),
                                                tuple(vals.shape)))
    if not (1 <= S <= MAX_SEGMENTS and 1 <= k <= MAX_K):
        raise ValueError("merge takes 1 <= S <= %d lists of 1 <= k <= %d, "
                         "got S %d, k %d" % (MAX_SEGMENTS, MAX_K, S, k))
    if kin != k:
        raise ValueError("merge takes lists of k = %d, got %d" % (k, kin))
    dev = vals.device
    pv = vals.contiguous()
    pi = idx.to(torch.int32).contiguous()
    out_v = torch.empty((N, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((N, k), dtype=torch.int64, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        dev, "sketch_merge", lib.isocon_sketch_merge,
        P(pv.data_ptr()), P(pi.data_ptr()), P(out_v.data_ptr()),
        P(out_i.data_ptr()), I(N), I(S), I(k), _stream(dev))
    return out_v, out_i


def topn_scores(prof_sqrt: torch.Tensor, lens: torch.Tensor, k: int,
                chunk: int = ROW_CHUNK):
    """(values float32 [N, k], indices int64 [N, k]): each row's ``topn``
    of the scores.  CUDA tensors: ``sketch_topn`` over all N rows in one
    launch with ``plan_segments``' count, then ``merge_topn``.  CPU
    tensors: the plain scores ``chunk`` rows at a time, each chunk's
    ``topn``."""
    N = prof_sqrt.shape[0]
    dev = prof_sqrt.device
    if N == 0 or k == 0:
        return (torch.empty((N, 0), dtype=torch.float32, device=dev),
                torch.empty((N, 0), dtype=torch.int64, device=dev))
    if dev.type != "cpu":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return merge_topn(*sketch_topn(prof_sqrt, lens, k,
                                       plan_segments(N, sms)), k)
    parts = [topn(sketch_scores_plain(prof_sqrt, lens, row0,
                                      min(chunk, N - row0)), k)
             for row0 in range(0, N, chunk)]
    return (torch.cat([v for v, _i in parts]),
            torch.cat([i for _v, i in parts]))


def topn_indices(prof_sqrt: torch.Tensor, lens: torch.Tensor, k: int,
                 chunk: int = ROW_CHUNK) -> torch.Tensor:
    """int64 [N, k]: each row's ``topn`` indices (``topn_scores``)."""
    return topn_scores(prof_sqrt, lens, k, chunk)[1]


# ---------------------------------------------------------------------------
# the profiles (K7) and their plain version
# ---------------------------------------------------------------------------
def kmer_profiles_plain(seq_bytes: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: float32 [N, DIM], row r the square roots of the
    hashed ``KMER``-mer counts of the bytes seq_bytes[offsets[r] ..
    offsets[r + 1]) (uint8 and int64 [N + 1], CPU tensors), zeros for a
    read under ``KMER`` bases.  Every read's keys in one pass over the
    concatenation: a key whose window runs past its read's end is dropped.
    numpy's square root, correctly rounded: torch 2.13's CPU build on an
    AVX-512 host returned float32 roots good to about 12 bits in some first
    calls after other work (sqrt(1) = 1 - 2^-12 on whole blocks of rows)."""
    off = offsets.numpy()
    n = off.size - 1
    counts = np.zeros(n * DIM, dtype=np.int64)
    width = int(off[-1] - off[0]) - KMER + 1 if n > 0 else 0
    if width > 0:
        codes = encode_bytes(seq_bytes.numpy()[off[0]:off[-1]]).astype(
            np.int64)
        keys = np.zeros(width, dtype=np.int64)
        for t in range(KMER):
            keys = keys * 5 + codes[t:t + width]
        row = np.repeat(np.arange(n), np.diff(off))[:width]
        keep = np.arange(width) + KMER <= off[1:][row] - off[0]
        with np.errstate(over="ignore"):
            h = keys[keep].astype(np.uint64) * np.uint64(KMER_HASH)
        bucket = (h >> np.uint64(HASH_SHIFT)) % np.uint64(DIM)
        counts += np.bincount(row[keep] * DIM + bucket.astype(np.int64),
                              minlength=n * DIM)
    return torch.from_numpy(np.sqrt(counts.reshape(n, DIM).astype(
        np.float32)))


def kmer_profiles(seq_bytes: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """float32 [N, DIM]: each read's square-rooted hashed k-mer counts, the
    ``prof_sqrt`` of ``topn_scores``, from the reads' ASCII bytes back to
    back (uint8) and their offsets (int64 [N + 1], non-decreasing, within
    the bytes): one launch of K7 for CUDA tensors, ``kmer_profiles_plain``
    for CPU tensors."""
    if seq_bytes.dtype != torch.uint8 or seq_bytes.dim() != 1:
        raise TypeError("seq_bytes must be uint8 [total]")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or \
            offsets.numel() == 0:
        raise TypeError("offsets must be int64 [N + 1]")
    if offsets.device != seq_bytes.device:
        raise ValueError("profile inputs on mixed devices")
    if seq_bytes.device.type == "cpu":
        return kmer_profiles_plain(seq_bytes, offsets)
    lib = _build.load("sketch")
    dev = seq_bytes.device
    N = offsets.numel() - 1
    out = torch.empty((N, DIM), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    buf, off = seq_bytes.contiguous(), offsets.contiguous()
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(dev, "kmer_profile", lib.isocon_kmer_profile,
                  P(buf.data_ptr()), P(off.data_ptr()), P(out.data_ptr()),
                  I(N), _stream(dev))
    return out
