"""MAM vote and correction of a round's dense partitions, all at once.

Counterpart of the per-member loop of ``correct_to_consensus``
(``correction_module.py:260-446``; ``isocon_tpu/correct/dense.py``).
Layout of a round (``correct/dense.py::correct_round`` packs it):

- ``mat`` uint8 [N]: each partition's MAM (``build_dense_mam``, K rows of
  W bytes), row-major, one after another;
- ``part`` int64 [P, 5]: a partition's byte offset in ``mat``, K, W, its
  first row among the round's rows and its first column among the round's
  columns;
- ``deg`` int64: each row's degree (the reads that share its string);
- ``rows`` int64 [2, R]: the rows to correct (members of degree 1; a
  converged member is never corrected) and their partitions.

``consensus_round`` returns (counts int64 [C, 5], maj uint8 [C], unamb
uint8 [C], errs int64 [P, 3], out uint8 [R, width], lens int32 [R], nmis
int32 [R]): each column's degree-weighted counts in ``ACGT-`` order (a
byte other than A, C, G, T counts as '-'), its majority code (the first
maximum) and whether that is the only maximum; each partition's c_ins,
c_del, c_subs over its unambiguous columns; each row to correct with the
chosen mismatches set to the majority and its '-' bytes removed, its
length and its number of mismatches (the row is corrected where that is
above 0).  A mismatch is an unambiguous column whose code is not the
majority's; its freq = count / max(c_type, 1) in float64 (c_ins where the
majority is '-', else c_del where the row's code is '-', else c_subs);
the chosen are those whose freq is at most the ceil(n / 2)-th smallest,
which is the reference's stable sort extended through ties at the cut.
The bytes of ``out`` past a row's length are not its own.

For CUDA tensors the two kernels of ``csrc/consensus.cu`` run
(``consensus_vote``, a thread a column; ``consensus_correct``, a block a
row); for CPU tensors ``consensus_plain``, the same in PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build

DASH = ord("-")
_CODE = torch.full((256,), 4, dtype=torch.int64)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
_CHAN = torch.tensor(list(b"ACGT-"), dtype=torch.uint8)


def consensus_round(mat: torch.Tensor, part: torch.Tensor, deg: torch.Tensor,
                    rows: torch.Tensor, *, cols: int, width: int):
    """The round's vote and correction (module docstring).  ``cols``: the
    round's columns (the sum of W); ``width``: the widest W, which bounds
    every corrected row's length."""
    if mat.device.type == "cpu":
        return consensus_plain(mat, part, deg, rows, cols=cols, width=width)
    return consensus_cuda(mat, part, deg, rows, cols=cols, width=width)


def consensus_cuda(mat: torch.Tensor, part: torch.Tensor, deg: torch.Tensor,
                   rows: torch.Tensor, *, cols: int, width: int):
    """The two launches of ``csrc/consensus.cu`` on the stream of
    ``mat``'s card; nothing waits for it."""
    if mat.dtype != torch.uint8:
        raise ValueError("mat must be uint8")
    dev = mat.device
    args_in = [mat.contiguous(), part.to(torch.int64).contiguous(),
               deg.to(torch.int64).contiguous(),
               rows.to(torch.int64).contiguous()]
    if any(a.device != dev for a in args_in):
        raise ValueError("consensus inputs on mixed devices")
    mat, part, deg, rows = args_in
    P, R = part.shape[0], rows.shape[1]
    counts = torch.empty((cols, 5), dtype=torch.int64, device=dev)
    maj = torch.empty(cols, dtype=torch.uint8, device=dev)
    unamb = torch.empty_like(maj)
    errs = torch.empty((P, 3), dtype=torch.int64, device=dev)
    out = torch.empty((R, max(width, 1)), dtype=torch.uint8, device=dev)
    lens = torch.empty(R, dtype=torch.int32, device=dev)
    nmis = torch.empty_like(lens)
    lib = _build.load("consensus")
    P_ = ctypes.c_void_p
    stream = P_(torch.cuda.current_stream(dev).cuda_stream)
    vote = [mat, part, deg, counts, maj, unamb, errs]
    _build.launch(dev, "consensus_vote", lib.isocon_consensus_vote,
                  *[P_(a.data_ptr()) for a in vote], ctypes.c_int(P),
                  ctypes.c_int(width), stream)
    if R:
        fix = [mat, part, rows, counts, maj, unamb, errs, out, lens, nmis]
        _build.launch(dev, "consensus_correct", lib.isocon_consensus_correct,
                      *[P_(a.data_ptr()) for a in fix], ctypes.c_int(R),
                      ctypes.c_int(out.shape[1]), stream)
    return counts, maj, unamb, errs, out, lens, nmis


def consensus_plain(mat: torch.Tensor, part: torch.Tensor, deg: torch.Tensor,
                    rows: torch.Tensor, *, cols: int, width: int):
    """``consensus_round`` in PyTorch on the CPU, a partition at a time; the
    bytes of ``out`` past a row's length are 0."""
    P, R = part.shape[0], rows.shape[1]
    counts = torch.zeros((cols, 5), dtype=torch.int64)
    maj = torch.zeros(cols, dtype=torch.uint8)
    unamb = torch.zeros(cols, dtype=torch.uint8)
    errs = torch.zeros((P, 3), dtype=torch.int64)
    out = torch.zeros((R, max(width, 1)), dtype=torch.uint8)
    lens = torch.zeros(R, dtype=torch.int32)
    nmis = torch.zeros(R, dtype=torch.int32)
    for p, (base, K, W, row0, col0) in enumerate(part.tolist()):
        m = mat[base:base + K * W].view(K, W)
        codes = _CODE[m.long()]
        flat = (codes + 5 * torch.arange(W)).view(-1)
        weights = deg[row0:row0 + K, None].expand(K, W).reshape(-1)
        cnt = torch.zeros(W * 5, dtype=torch.int64).index_add_(
            0, flat, weights).view(W, 5)
        mx = cnt.max(dim=1).values
        ua = (cnt == mx[:, None]).sum(dim=1) == 1
        mj = cnt.argmax(dim=1)           # the first maximum
        gap = mj == 4
        other = cnt.sum(dim=1) - mx
        dash = cnt[:, 4]
        errs[p, 0] = other[ua & gap].sum()
        errs[p, 1] = dash[ua & ~gap].sum()
        errs[p, 2] = (other - dash)[ua & ~gap].sum()
        counts[col0:col0 + W] = cnt
        maj[col0:col0 + W] = mj.to(torch.uint8)
        unamb[col0:col0 + W] = ua.to(torch.uint8)

        slots = (rows[1] == p).nonzero().view(-1)
        if not slots.numel():
            continue
        local = rows[0, slots] - row0
        rc = codes[local]                                  # [Rp, W]
        mis = ua[None, :] & (rc != mj[None, :])
        n = mis.sum(dim=1)
        ri, j = mis.nonzero(as_tuple=True)                 # row-major
        cj = rc[ri, j]
        norm = errs[p].clamp(min=1).to(torch.float64)      # ins, del, subs
        kind = torch.where(gap[j], 0, torch.where(cj == 4, 1, 2))
        freq = cnt[j, cj].to(torch.float64) / norm[kind]
        new = m[local].clone()
        if freq.numel():
            # sorted by row, then freq: each row's ceil(n / 2)-th smallest
            order = torch.sort(freq, stable=True).indices
            order = order[torch.sort(ri[order], stable=True).indices]
            first = torch.cumsum(n, 0) - n
            kth = (first + (n + 1) // 2 - 1).clamp(min=0)
            cutoff = freq[order][kth]
            chosen = freq <= cutoff[ri]
            new[ri[chosen], j[chosen]] = _CHAN[mj[j[chosen]]]
        keep = new != DASH
        pos = keep.cumsum(dim=1) - 1
        kr, kc = keep.nonzero(as_tuple=True)
        out[slots[kr], pos[kr, kc]] = new[kr, kc]
        lens[slots] = keep.sum(dim=1).to(torch.int32)
        nmis[slots] = n.to(torch.int32)
    return counts, maj, unamb, errs, out, lens, nmis


def fetch(outs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host copies of ``consensus_round``'s row outputs: (lens, nmis, rows
    uint8 [R, A]), the rows trimmed to the longest corrected length.  Two
    copies: the two vectors, then the rows."""
    out, lens, nmis = outs[4], outs[5], outs[6]
    vec = torch.stack([lens, nmis]).cpu().numpy()
    fixed = vec[1] > 0
    A = max(int(vec[0][fixed].max()), 1) if fixed.any() else 1
    return vec[0], vec[1], out[:, :A].cpu().numpy()
