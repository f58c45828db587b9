"""Banded bit-parallel Myers/Hyyro edit distance over a sequence pool: NW
(global, K1) and HW (infix, K2).

Counterpart of ``isocon_tpu/ops/myers_pallas.py`` (``myers_ed_pool`` /
``myers_hw_pool``, ``_myers_ed``, ``_kernel`` with ``HW`` False / True).  DP
columns are vertical-delta bit vectors, 32 rows per uint32 word; a window
of ``win`` words follows the diagonal (W0 = clip(p - win//2, 0,
nwords - win) in phase p of 32 text columns).  The window top feeds
hin = +1 (exact at row 0, an upper bound once the window has moved), and
fresh bottom words enter as all-(+1) deltas.  S(j) = D[j][j] is tracked,
latched at column n (base), and row n is walked to column m:
D[n][m] = base + walk.  The pair is swapped so that n <= m.  Codes
{0,1,2,3,5} (ACGT and N) have Peq planes; other codes match nothing.

A result is exact where ``myers_certifies`` holds and an upper bound
otherwise.  ``win=None`` runs the full-width window (win = L/32): W0 stays
0, so the recurrence is unbanded Myers and every result is exact.

Peq planes are built once per pool row (``peq_table``) rather than once
per pair: the planes depend only on the query row, and the pool holds each
sequence once.

HW mode (edlib's infix mode: free target start and end) takes the pair as
given, query = row ``ia``, no swap, and n may exceed m.  Row 0 of the DP is
all zero: the window top feeds hin = 0 while it sits at row 0 and +1 once
it has moved.  The sweep runs to column max(n, m) (the target reads as a
code without a plane past m), W(j) = the sum of row n's horizontal deltas
over the columns where row n's word is in the window, and the answer is
min over jlow <= j <= m of D[n][n] + W(j) - W(n), the smallest j on ties,
with jlow = max(n - margin, 1); the delete-whole-query end D[n][0] = n
competes and wins ties (``ej`` = 0).  A result is exact where
``myers_certifies_hw`` holds.  At the full width every column of row n is
in the window and jlow = 1.

The CUDA kernels are in ``csrc/myers_ed.cu``; ``myers_ed_pool`` and
``myers_hw_pool`` launch them for CUDA tensors and run ``myers_ed_plain``
/ ``myers_hw_plain`` for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

PLANES = (0, 1, 2, 3, 5)
WIN = 7
MASK = 0xFFFFFFFF

# code -> plane index (-1: no plane)
_PLANE_OF = np.full(256, -1, dtype=np.int64)
for _ci, _c in enumerate(PLANES):
    _PLANE_OF[_c] = _ci


def peq_table(pool: torch.Tensor, plen: torch.Tensor) -> torch.Tensor:
    """Peq bit planes of every pool row: int32 [R, 5, Lp/32], bit r of word
    w set where row position 32*w + r (< the row's length) holds the
    plane's code.  Words are uint32 bit patterns stored as int32."""
    R, Lp = pool.shape
    if Lp % 32:
        raise ValueError("pool width must be a multiple of 32, got %d" % Lp)
    pos = torch.arange(Lp, device=pool.device)
    live = pos[None, :] < plen[:, None].to(torch.int64)
    weights = (torch.ones(32, dtype=torch.int64, device=pool.device)
               << torch.arange(32, device=pool.device))
    planes = []
    for code in PLANES:
        bits = ((pool == code) & live).view(R, Lp // 32, 32).to(torch.int64)
        w = (bits * weights).sum(dim=2)
        planes.append(torch.where(w >= 2 ** 31, w - 2 ** 32, w))
    return torch.stack(planes, dim=1).to(torch.int32)


def myers_certifies(ed: np.ndarray, qlen: np.ndarray, tlen: np.ndarray,
                    win: int = WIN) -> np.ndarray:
    margin = 32 * (win // 2)  # rows guaranteed active on both diagonal sides
    delta = np.abs(tlen.astype(np.int64) - qlen.astype(np.int64))
    v = ed.astype(np.int64)
    return (
        (v + delta <= 2 * margin)
        & (v - delta <= 2 * margin)
        & (delta <= margin - 1)
        & (v >= 0)
    )


def myers_certifies_hw(ed: np.ndarray, qlen: np.ndarray, tlen: np.ndarray,
                       win: int = WIN) -> np.ndarray:
    """HW-mode certification: the window covers offsets j - i in
    [-margin, margin]; a cost-v path has offsets in [-v, max(delta, 0) + v]
    with the target start drifting at most v further."""
    margin = 32 * (win // 2)
    delta = tlen.astype(np.int64) - qlen.astype(np.int64)
    v = ed.astype(np.int64)
    return (v >= 0) & (v <= margin) & (np.maximum(delta, 0) + 2 * v <= margin)


def myers_ed_plain(peq: torch.Tensor, text: torch.Tensor, n: torch.Tensor,
                   m: torch.Tensor, *, L: int, win: int) -> torch.Tensor:
    """Plain PyTorch version of K1, vectorised over the batch.

    peq: [B, 5, >= nwords'] Peq words of each pair's query (n <= m);
    text: [B, >= max(m)] target codes; n, m: [B].  Returns ed int32 [B].
    """
    if text.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=text.device)
    base, walk = _sweep(peq, text, n, m, L=L, win=win, full=win == L // 32,
                        hw=False)
    return (base + walk).to(torch.int32)


def myers_hw_plain(peq: torch.Tensor, text: torch.Tensor, n: torch.Tensor,
                   m: torch.Tensor, *, L: int, win: int,
                   full: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, vectorised over the batch.

    Arguments as ``myers_ed_plain``, but the pair is taken as given (query
    n, target m, either may be longer) and text is [B, >= max(n, m)].
    full: the full-width window (win == L // 32, jlow = 1).  Returns
    (ed, ej) int32 [B]; ej is the 1-indexed exclusive end of the target
    span, 0 for the empty span."""
    if text.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int32, device=text.device)
        return z, z.clone()
    if full and win != L // 32:
        raise ValueError("full window needs win == L // 32")
    base, wn, wmin, wj = _sweep(peq, text, n, m, L=L, win=win, full=full,
                                hw=True)
    n = n.to(torch.int64)
    v = base + wmin - wn
    ed = torch.minimum(v, n)
    ej = torch.where(n <= v, torch.zeros_like(wj), wj)
    return ed.to(torch.int32), ej.to(torch.int32)


def _sweep(peq, text, n, m, *, L: int, win: int, full: bool, hw: bool):
    """The column sweep both plain versions share.  Words are held in
    int64 and masked to 32 bits after the carry add and after each shift.
    Returns (base, walk) in NW mode and (base, wn, wmin, wj) in HW mode,
    int64 [B]."""
    dev = text.device
    B = text.shape[0]
    nwords = L // 32
    n = n.to(torch.int64)
    m = m.to(torch.int64)
    nword = torch.div(n - 1, 32, rounding_mode="floor")
    nbitpos = (n - 1) % 32
    # full window: W0 stays 0 and words below row n's word never reach
    # rows <= n, so the sweep stops at the deepest row-n word
    kmax = int(nword.max()) + 1 if full else win
    kmax = max(1, min(kmax, win))
    pw = peq.shape[2]
    if pw < nwords:
        peq = torch.cat([peq, peq.new_zeros(B, 5, nwords - pw)], dim=2)
    peq = peq.to(torch.int64) & MASK
    # a 6th all-zero plane for codes without one
    peq = torch.cat([peq, peq.new_zeros(B, 1, peq.shape[2])], dim=1)
    plane_of = torch.from_numpy(_PLANE_OF).to(dev)
    plane_of = torch.where(plane_of < 0, len(PLANES), plane_of)
    ones = torch.full((B,), MASK, dtype=torch.int64, device=dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    pvs = [ones] * kmax
    mvs = [zeros] * kmax
    sdiag = zeros
    base = zeros
    walk = zeros
    half = win // 2
    mmax = int(m.max())
    if hw:
        # column n carries the anchor even when n > m
        mmax = max(mmax, int(n.max()))
        wn = zeros
        wmin = torch.full((B,), 1 << 29, dtype=torch.int64, device=dev)
        wj = zeros
        jlow = (torch.ones_like(n) if full
                else (n - 32 * half).clamp(min=1))
    for p in range((mmax + 31) // 32):
        W0 = min(max(p - half, 0), nwords - win)
        dslot = p - W0
        if half + 1 <= p <= nwords - win + half:
            pvs = pvs[1:] + [ones]
            mvs = mvs[1:] + [zeros]
        peqw = peq[:, :, W0:W0 + kmax]                      # [B, 6, kmax]
        rsel = nword - W0
        rin = (rsel >= 0) & (rsel < kmax)
        rsel = rsel.clamp(0, kmax - 1)
        for s in range(32):
            col = 32 * p + s
            if col >= mmax:
                break
            j = col + 1
            code = plane_of[text[:, col].to(torch.int64)]
            if hw:      # past its end the target matches nothing
                code = torch.where(col < m, code,
                                   torch.full_like(code, len(PLANES)))
            eqs = torch.gather(peqw, 1, code[:, None, None].expand(
                B, 1, kmax))[:, 0, :]                        # [B, kmax]
            if dslot < kmax:
                vplus = (pvs[dslot] >> s) & 1
                vminus = (mvs[dslot] >> s) & 1
            else:
                vplus = vminus = zeros
            sdiag = sdiag + vplus - vminus
            # window top: +1, or 0 in HW mode while it sits at row 0
            hp = 0 if hw and W0 == 0 else 1
            hm = 0
            phs = []
            mhs = []
            new_pvs = []
            new_mvs = []
            for k in range(kmax):
                pv = pvs[k]
                mv = mvs[k]
                eq = eqs[:, k]
                xv = eq | mv
                eq = eq | hm
                xh = ((((eq & pv) + pv) & MASK) ^ pv) | eq
                ph = mv | ((xh | pv) ^ MASK)
                mh = pv & xh
                phs.append(ph)
                mhs.append(mh)
                hout_p = ph >> 31
                hout_m = mh >> 31
                ph = ((ph << 1) & MASK) | hp
                mh = ((mh << 1) & MASK) | hm
                new_pvs.append(mh | ((xv | ph) ^ MASK))
                new_mvs.append(ph & xv)
                hp, hm = hout_p, hout_m
            pvs, mvs = new_pvs, new_mvs
            if dslot < kmax:
                hplus = (phs[dslot] >> s) & 1
                hminus = (mhs[dslot] >> s) & 1
                sdiag = sdiag + hplus - hminus
            base = torch.where(n == j, sdiag, base)
            php = torch.stack(phs, dim=1).gather(1, rsel[:, None])[:, 0]
            mhp = torch.stack(mhs, dim=1).gather(1, rsel[:, None])[:, 0]
            hbp = (php >> nbitpos) & 1
            hbm = (mhp >> nbitpos) & 1
            if hw:
                walk = walk + torch.where(rin, hbp - hbm, zeros)
                wn = torch.where(n == j, walk, wn)
                better = (j >= jlow) & (j <= m) & (walk < wmin)
                wmin = torch.where(better, walk, wmin)
                wj = torch.where(better, torch.full_like(wj, j), wj)
            else:
                in_walk = rin & (j > n) & (j <= m)
                walk = walk + torch.where(in_walk, hbp - hbm, zeros)
    if hw:
        return base, wn, wmin, wj
    return base, walk


def _swap(plen, ia, ib):
    la = plen[ia]
    lb = plen[ib]
    swap = la > lb
    qrow = torch.where(swap, ib, ia)
    trow = torch.where(swap, ia, ib)
    n = torch.where(swap, lb, la)
    m = torch.where(swap, la, lb)
    return qrow, trow, n, m


def _geometry(pool: torch.Tensor, L: int, win: Optional[int]) -> int:
    """The window's words for ``win`` (None: the full width); raises on a
    geometry the kernels do not take."""
    Lp = pool.shape[1]
    w = L // 32 if win is None else int(win)
    if L % 32 or L < 32 * w or L < Lp or w < 1:
        raise ValueError("bad Myers geometry L=%d win=%s Lp=%d" % (L, win, Lp))
    return w


def myers_ed_pool(pool: torch.Tensor, plen: torch.Tensor, peq: torch.Tensor,
                  ia: torch.Tensor, ib: torch.Tensor, *, L: int,
                  win: Optional[int] = WIN) -> torch.Tensor:
    """Edit distances of pool-row pairs (ia[b], ib[b]).

    pool: uint8 [R, Lp]; plen: int32 [R]; peq: ``peq_table(pool, plen)``;
    ia/ib: int32 [B].  L: the kernel's padded length (L % 32 == 0,
    L >= 32*win, L >= Lp); it fixes where the window clips, so results
    that do not certify depend on it.  win=None: full-width window.
    Returns ed int32 [B] on the pool's device."""
    w = _geometry(pool, L, win)
    qrow, trow, n, m = _swap(plen, ia.long(), ib.long())
    if pool.device.type == "cpu":
        return myers_ed_plain(peq[qrow], pool[trow], n, m, L=L, win=w)
    return _myers_cuda(pool, peq, qrow, trow, n, m, L=L, win=w,
                       full=win is None, hw=False)


def myers_hw_pool(pool: torch.Tensor, plen: torch.Tensor, peq: torch.Tensor,
                  ia: torch.Tensor, ib: torch.Tensor, *, L: int,
                  win: Optional[int] = WIN
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HW-mode (infix) distances of pool-row pairs: query row ia[b] inside
    target row ib[b], no swap.  Arguments as ``myers_ed_pool``.  Returns
    (ed, ej) int32 [B] on the pool's device."""
    w = _geometry(pool, L, win)
    qrow, trow = ia.long(), ib.long()
    n, m = plen[qrow], plen[trow]
    if pool.device.type == "cpu":
        return myers_hw_plain(peq[qrow], pool[trow], n, m, L=L, win=w,
                              full=win is None)
    return _myers_cuda(pool, peq, qrow, trow, n, m, L=L, win=w,
                       full=win is None, hw=True)


_KERNEL_WINS = (7, 9, 17, 33)


def _myers_cuda(pool, peq, qrow, trow, n, m, *, L, win, full, hw):
    """Launch K1 (hw=False; returns ed) or K2 (hw=True; returns (ed, ej))."""
    lib = _build.load("myers_ed")
    dev = pool.device
    B = qrow.shape[0]
    for tns in (peq, qrow, trow, n, m):
        if tns.device != dev:
            raise ValueError("Myers inputs on mixed devices")
    if pool.dtype != torch.uint8 or peq.dtype != torch.int32:
        raise TypeError("pool must be uint8 and peq int32")
    if not full and win not in _KERNEL_WINS:
        raise ValueError("no Myers kernel for win=%d" % win)
    pool = pool.contiguous()
    if pool.data_ptr() % 16:
        raise ValueError("the Myers kernels read the pool in 16-byte words")
    peq = peq.contiguous()
    qrow = qrow.to(torch.int32).contiguous()
    trow = trow.to(torch.int32).contiguous()
    n = n.to(torch.int32).contiguous()
    m = m.to(torch.int32).contiguous()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    ej = torch.empty(B, dtype=torch.int32, device=dev) if hw else None
    if B == 0:
        return (out, ej) if hw else out
    stream = torch.cuda.current_stream(dev).cuda_stream
    P = ctypes.c_void_p
    ins = [P(pool.data_ptr()), P(peq.data_ptr()), P(qrow.data_ptr()),
           P(trow.data_ptr()), P(n.data_ptr()), P(m.data_ptr()),
           P(out.data_ptr())]
    geom = [ctypes.c_int(B), ctypes.c_int(pool.shape[1]), ctypes.c_int(L),
            ctypes.c_int(0 if full else win), P(stream)]
    if hw:
        _build.launch(dev, "myers_hw", lib.isocon_myers_hw, *ins,
                      P(ej.data_ptr()), *geom)
        return out, ej
    _build.launch(dev, "myers_ed", lib.isocon_myers_ed, *ins, *geom)
    return out
