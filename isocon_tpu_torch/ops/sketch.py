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

``sketch_scores`` launches the CUDA kernel ``csrc/sketch.cu`` for CUDA
tensors and runs ``sketch_scores_plain`` for CPU tensors.  ``topn`` is a
stable descending sort: on ties the lower index comes first, as
``lax.top_k`` gives it, and the list order matters to the graph, which
inserts edges in it.  ``topn_indices`` scores the rows in chunks of
``ROW_CHUNK`` so that the whole [N, N] matrix never exists at once.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

ROW_CHUNK = 4096
DIAG_PENALTY = 1e9


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
    ``lens`` (int [N]): K6 for CUDA tensors, the plain version for CPU
    tensors."""
    if prof_sqrt.device.type == "cpu":
        return sketch_scores_plain(prof_sqrt, lens, row0, rows)
    return _sketch_cuda(prof_sqrt, lens, row0, rows)


def _sketch_cuda(prof_sqrt, lens, row0, rows):
    """Launch K6; returns float32 [rows, N]."""
    lib = _build.load("sketch")
    dev = prof_sqrt.device
    if lens.device != dev:
        raise ValueError("sketch inputs on mixed devices")
    if prof_sqrt.dtype != torch.float32 or prof_sqrt.dim() != 2:
        raise TypeError("prof_sqrt must be float32 [N, D]")
    N, D = prof_sqrt.shape
    if D % 32:
        raise ValueError("K6 takes D a multiple of 32, got %d" % D)
    if not 0 <= row0 <= row0 + rows <= N:
        raise ValueError("rows %d .. %d outside 0 .. %d"
                         % (row0, row0 + rows, N))
    p = prof_sqrt.contiguous()
    ln = lens.to(torch.int32).contiguous()
    out = torch.empty((rows, N), dtype=torch.float32, device=dev)
    if rows == 0 or N == 0:
        return out
    P = ctypes.c_void_p
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.isocon_sketch_scores(
        P(p.data_ptr()), P(ln.data_ptr()), P(out.data_ptr()),
        ctypes.c_int(N), ctypes.c_int(D), ctypes.c_int(row0),
        ctypes.c_int(rows), P(stream))
    _build.check(rc, "sketch_scores")
    _build.LAUNCHES["sketch_scores"] += 1
    return out


def topn(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, in
    descending order, the lower index first among equal values."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def topn_indices(prof_sqrt: torch.Tensor, lens: torch.Tensor, k: int,
                 chunk: int = ROW_CHUNK) -> torch.Tensor:
    """int64 [N, k]: each row's ``topn`` indices, scored ``chunk`` rows at
    a time."""
    N = prof_sqrt.shape[0]
    parts = []
    for row0 in range(0, N, chunk):
        rows = min(chunk, N - row0)
        parts.append(topn(sketch_scores(prof_sqrt, lens, row0, rows), k)[1])
    return (torch.cat(parts) if parts else
            torch.empty((0, k), dtype=torch.int64, device=prof_sqrt.device))
