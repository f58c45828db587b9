"""Banded unit-cost edit distance as an anti-diagonal wavefront (K5), NW
(global) and HW (infix), for buckets wider than the Myers kernels take.

Counterpart of ``isocon_tpu/ops/wavefront.py`` (``banded_ed``,
``banded_ed_pool``, ``band_certifies``) and of the Pallas kernel
``isocon_tpu/ops/wavefront_pallas.py`` (``banded_ed_pallas``).

Geometry.  Cell (i, j) of the Levenshtein DP of q (n codes) against t (m
codes) lies on anti-diagonal d = i + j at band offset o = j - i.  The band
holds the Wp offsets o_lo .. o_lo + Wp - 1 with o_lo = -(Wp/2 - 1), one per
lane.  With A = diagonal d-1 and B2 = diagonal d-2 indexed by lane,

    new[o] = min(min(A[o+1], A[o-1]) + 1, B2[o] + (q[i-1] != t[j-1]))

for d = 2 .. n + m.  Row 0 holds d (0 in HW mode: the target's start is
free), column 0 holds d, lanes outside the grid (|o| > d) and every value
above the ceiling hold the ceiling: 120 for ``small`` bands (Wp <= 192),
16,000 above.  Only lanes with o = d (mod 2) are DP cells; the others stay
at the ceiling.  Positions at or past a sequence's length read as pad codes
(QPAD for q, TPAD for t) that equal no base code and not each other, so
the recurrence runs on past row n and column m.

Answers.  NW: the value on diagonal n + m in lane clip(m - n - o_lo, 0,
Wp - 1), which is the cell (n, m) when m - n lies in the band, and
otherwise an edge lane (a cell past the grid, or the ceiling);
``end_j`` = m.  HW: the strict running minimum over row n, cells (n, j)
with n + j >= 2 in the band, in order of j, so ties keep the smallest end;
``end_j`` = j.  The cells before diagonal 2 seed it: n = 0 gives 0, n = 1
gives 1, and otherwise it starts unset (2^30 for ``small`` bands, 16,000
above, as the two JAX versions start it), which is also the answer when no
cell of row n is in the band.

A result is exact where ``band_certifies`` holds; the engine escalates Wp
for the others.

``banded_ed_pool`` launches the CUDA kernel ``csrc/wavefront_ed.cu`` for
CUDA tensors (its C entry picks the register kernel at bands 128, 256, 512
and 1024 and the wide kernel at any other) and runs ``banded_ed_plain``
for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

CLAMP8 = 120    # ceiling of small bands; >= CLAMP8 means "beyond the band"
INF = 16000     # ceiling of the wider bands
QPAD = 5        # q past its length; never equals TPAD
TPAD = 6
SMALL_WP = 192  # bands up to this width are ``small``
_UNSET_SMALL = 2 ** 30

# Bands outside the register kernel's (128 .. 1024) run the wide kernel,
# which keeps two diagonals of Wp/2 int32 cells in shared memory: 4 * Wp
# bytes, 128 KB at this width (a block can opt into 227 KB).  Wider bands
# use a scratch tensor in device memory, one row per resident block.
SHARED_MAX_WP = 32768
SCRATCH_BLOCKS = 1056   # 132 SMs x 8 blocks


def band_certifies(ed: np.ndarray, qlen: np.ndarray, tlen: np.ndarray, Wp: int,
                   hw_mode: bool = False, small: bool = False) -> np.ndarray:
    """True where the banded result is exact: every path of cost <= v stays
    inside the band.  NW: prefix deletions <= (v + delta) / 2 and prefix
    insertions <= (v - delta) / 2 bound the offsets, and the answer lane
    itself must be in the band.  HW: an optimal path starts at (0, j0) with
    j0 <= max(0, delta + v) and drifts at most v further up and at most v
    below zero.  ``small`` bands saturate at CLAMP8, so only values below
    it are real."""
    o_lo = -(Wp // 2 - 1)
    o_hi = o_lo + Wp - 1
    delta = tlen.astype(np.int64) - qlen.astype(np.int64)
    v = ed.astype(np.int64)
    if hw_mode:
        cert = (v <= -o_lo) & (np.maximum(delta, 0) + 2 * v <= o_hi)
    else:
        cert = ((v + delta <= 2 * o_hi) & (v - delta <= -2 * o_lo)
                & (delta <= o_hi) & (delta >= o_lo))
    if small:
        cert &= v < CLAMP8
    return cert


def _ceilings(Wp: int, small: bool) -> Tuple[int, int]:
    """(ceiling, unset HW answer) of a band."""
    if Wp < 8 or Wp % 4:
        raise ValueError("band width must be a multiple of 4, >= 8; got %d"
                         % Wp)
    return (CLAMP8, _UNSET_SMALL) if small else (INF, INF)


def banded_ed_plain(qcodes: torch.Tensor, tcodes: torch.Tensor,
                    qlen: torch.Tensor, tlen: torch.Tensor, *, Wp: int,
                    hw_mode: bool = False, small: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: the recurrence as tensor ops over
    [B, Wp], one step per anti-diagonal d = 2 .. max(n + m).

    qcodes, tcodes: [B, Lq], [B, Lt] codes (what lies past a length is not
    read); qlen, tlen: [B].  Returns (ed, end_j) int32 [B]."""
    ceil_val, unset = _ceilings(Wp, small)
    dev = qcodes.device
    B = qcodes.shape[0]
    if B == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z.clone()
    n = qlen.to(torch.int32)[:, None]
    m = tlen.to(torch.int32)[:, None]
    if int(n.max()) > qcodes.shape[1] or int(m.max()) > tcodes.shape[1]:
        raise ValueError("a length exceeds its code plane's width")
    o_lo = -(Wp // 2 - 1)
    o = o_lo + torch.arange(Wp, dtype=torch.int32, device=dev)[None, :]
    ceil_t = torch.full((1, 1), ceil_val, dtype=torch.int32, device=dev)
    ceil_col = ceil_t.expand(B, 1)
    top1 = 0 if hw_mode else 1
    A = torch.where(o == 1, top1, torch.where(o == -1, 1, ceil_t)
                    ).expand(B, Wp)                       # diagonal 1
    B2 = torch.where(o == 0, 0, ceil_t).expand(B, Wp)     # diagonal 0
    d_final = n + m
    if hw_mode:
        res = torch.where(n == 0, 0, torch.where(n == 1, 1, unset))
    else:
        res = torch.where(d_final <= 1, torch.maximum(n, m), unset)
        lane_final = (m - n - o_lo).clamp(0, Wp - 1).to(torch.int64)
    res = res.to(torch.int32)
    endj = torch.zeros_like(res)
    qmax = qcodes.shape[1] - 1
    tmax = tcodes.shape[1] - 1
    for d in range(2, int(d_final.max()) + 1):
        # lane -> position in q and in t: the same for every pair
        xq = d - o[0] - 2               # 2 * (i - 1), or that plus 1
        xt = d + o[0] - 2
        iq = xq >> 1
        it = xt >> 1
        qg = torch.where((xq >= 0) & (iq < n),
                         qcodes.index_select(1, iq.clamp(0, qmax)), QPAD)
        tg = torch.where((xt >= 0) & (it < m),
                         tcodes.index_select(1, it.clamp(0, tmax)), TPAD)
        up = torch.cat([A[:, 1:], ceil_col], dim=1)       # A[o+1]
        down = torch.cat([ceil_col, A[:, :-1]], dim=1)    # A[o-1]
        new = torch.minimum(torch.minimum(up, down) + 1, B2 + (qg != tg))
        # row 0, then column 0, then the lanes outside the grid
        d_c = min(d, ceil_val)
        edge = torch.where(o == d, 0 if hw_mode else d_c, ceil_t)
        edge = torch.where(o == -d, d_c, edge)
        new = torch.where(o.abs() >= d, edge, new)
        new = torch.minimum(new, ceil_t)
        if hw_mode:
            lane = d - 2 * n - o_lo     # the cell (n, d - n)
            ok = (lane >= 0) & (lane < Wp) & (d >= n) & (d <= d_final)
            v = new.gather(1, lane.clamp(0, Wp - 1).to(torch.int64))
            better = ok & (v < res)
            endj = torch.where(better, d - n, endj)
            res = torch.where(better, v, res)
        else:
            res = torch.where(d == d_final, new.gather(1, lane_final), res)
        B2, A = A, new
    if not hw_mode:
        endj = m.clone()
    return res[:, 0], endj[:, 0]


def banded_ed_pool(pool: torch.Tensor, plen: torch.Tensor, ia: torch.Tensor,
                   ib: torch.Tensor, *, Wp: int, hw_mode: bool = False,
                   small: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded edit distances of pool-row pairs: query row ia[b] against
    target row ib[b], in a band of Wp lanes, ``small`` (default: where
    Wp <= SMALL_WP, the engine's choice; the JAX ``banded_ed``'s own
    default is False at any Wp).

    pool: uint8 [R, Lp]; plen: int32 [R]; ia/ib: int [B].  Returns
    (ed, end_j) int32 [B] on the pool's device."""
    if small is None:
        small = Wp <= SMALL_WP
    qrow, trow = ia.long(), ib.long()
    n, m = plen[qrow], plen[trow]
    if pool.device.type == "cpu":
        return banded_ed_plain(pool[qrow], pool[trow], n, m, Wp=Wp,
                               hw_mode=hw_mode, small=small)
    return _wavefront_cuda(pool, qrow, trow, n, m, Wp=Wp, hw_mode=hw_mode,
                           small=small)


def _wavefront_cuda(pool, qrow, trow, n, m, *, Wp, hw_mode, small):
    """Launch K5; returns (ed, end_j)."""
    ceil_val, unset = _ceilings(Wp, small)
    lib = _build.load("wavefront_ed")
    dev = pool.device
    B = qrow.shape[0]
    for tns in (qrow, trow, n, m):
        if tns.device != dev:
            raise ValueError("wavefront inputs on mixed devices")
    if pool.dtype != torch.uint8:
        raise TypeError("pool must be uint8")
    pool = pool.contiguous()
    qrow = qrow.to(torch.int32).contiguous()
    trow = trow.to(torch.int32).contiguous()
    n = n.to(torch.int32).contiguous()
    m = m.to(torch.int32).contiguous()
    ed = torch.empty(B, dtype=torch.int32, device=dev)
    ej = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ed, ej
    # the register kernel's pair counter; the C entry zeroes it
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    rows = 0
    scratch = None
    if Wp > SHARED_MAX_WP:
        rows = min(B, SCRATCH_BLOCKS)
        scratch = torch.empty((rows, Wp), dtype=torch.int32, device=dev)
    P = ctypes.c_void_p
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch(
        dev, "wavefront_ed", lib.isocon_wavefront_ed,
        P(pool.data_ptr()), P(qrow.data_ptr()), P(trow.data_ptr()),
        P(n.data_ptr()), P(m.data_ptr()), P(ed.data_ptr()),
        P(ej.data_ptr()), P(counter.data_ptr()),
        P(scratch.data_ptr() if rows else None),
        ctypes.c_int(B), ctypes.c_int(pool.shape[1]), ctypes.c_int(Wp),
        ctypes.c_int(int(hw_mode)), ctypes.c_int(ceil_val),
        ctypes.c_int(unset), ctypes.c_int(rows), P(stream))
    return ed, ej
