"""Banded affine-gap semi-global alignment with traceback: constants, the
plain PyTorch versions of the forward DP (K3), the traceback walk (K4) and
K4's epilogue (the aligned rows), and the host respelling of those rows.

Counterpart of ``isocon_tpu/ops/affine.py`` (``banded_sg_align``,
``walk_traceback``) and of the compacted Pallas kernels in
``isocon_tpu/ops/affine_pallas_c.py``.  The recurrence, maximised over
three state planes with free end gaps in both sequences:

    H[i][j] = max(H[i-1][j-1] + s(i,j), E[i][j], F[i][j])
    E[i][j] = max(H[i][j-1] - open, E[i][j-1] - ext)   # gap consuming t
    F[i][j] = max(H[i-1][j] - open, F[i-1][j] - ext)   # gap consuming q

A gap of length g costs open + (g-1)*ext (parasail's convention).  Ties:
diag > E > F for H, open >= extend for E and F.  Endpoint: the max-score
cell of the last row or column, then larger i, then larger j, seeded at
(score 0, i = n, j = 0).

Band layout (parity-compacted, shared with ``csrc/affine_sg.cu``): on
anti-diagonal d = i + j, lane u in [0, W) with W = Wp/2 holds the cell at
offset o = j - i = 2u + AE for even d and 2u + AO for odd d, where
AE = -(Wp/2 - 2) and AO = AE - 1.  These are exactly the real cells of the
classic band o in [-(Wp/2 - 1), Wp/2].  A parent outside the band reads
NEG, as in the lax.scan reference.  Each cell stores one direction byte:
bits 0-1 the H source (H_DIAG/H_FROME/H_FROMF/H_START), bit 2 "E opened
here", bit 3 "F opened here".

The walk starts at the endpoint and emits one opcode per step, backward
and contiguous, OP_NONE after it ends; it flags band overflow when an
active step sits on an edge lane (o <= o_lo or o >= Wp/2).  Scores are
int32 with every state floored at NEG after each step.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG = -16000  # floor of every state (the int16 reference's NEG)
QPAD = 5
TPAD = 6

# H-direction codes (bits 0-1)
H_DIAG = 0
H_FROME = 1
H_FROMF = 2
H_START = 3  # boundary cell (free end gap start)
# bit 2: E opened here; bit 3: F opened here


class BandOverflow(Exception):
    pass


# backward-walk opcodes emitted by the device-side decoder
OP_NONE = 0   # walk finished / padding
OP_DIAG = 1   # consume one char of q and t
OP_GAPQ = 2   # E-state: '-' in q, consume t
OP_GAPT = 3   # F-state: consume q, '-' in t



def band_consts(Wp: int) -> Tuple[int, int, int]:
    """(W, AE, AO) of the compacted band of width Wp."""
    if Wp < 8 or Wp % 4:
        raise ValueError("band width must be a multiple of 4, got %d" % Wp)
    AE = -(Wp // 2 - 2)
    return Wp // 2, AE, AE - 1


def _chars(rows: torch.Tensor, lens: torch.Tensor, idx: torch.Tensor,
           pad: int) -> torch.Tensor:
    """rows[b, idx[b, u]] where 0 <= idx < lens[b], else ``pad``."""
    Lp = rows.shape[1]
    ok = (idx >= 0) & (idx < lens[:, None])
    g = torch.gather(rows, 1, idx.clamp(0, Lp - 1))
    return torch.where(ok, g, torch.full_like(g, pad))


def sg_forward_plain(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor, match: torch.Tensor,
                     mismatch: torch.Tensor, gopen: torch.Tensor,
                     gext: torch.Tensor, Wp: int):
    """Plain version of K3.

    q/t: [B, Lp] integer codes; qlen/tlen and the scores: [B].  Returns
    (best, ei, ej) int32 [B] and dirs uint8 [B, S, W] for diagonals
    d = 2 .. S + 1, S = max(qlen + tlen) - 1.
    """
    dev = q.device
    B = q.shape[0]
    W, AE, AO = band_consts(Wp)
    q = q.to(torch.int32)
    t = t.to(torch.int32)
    n = qlen.to(torch.int32)
    m = tlen.to(torch.int32)
    ma = match.to(torch.int32)[:, None]
    mi = mismatch.to(torch.int32)[:, None]
    go = gopen.to(torch.int32)[:, None]
    ge = gext.to(torch.int32)[:, None]
    dmax = int((n + m).max()) if B else 0
    S = max(dmax - 1, 1)
    dirs = torch.zeros((B, S, W), dtype=torch.uint8, device=dev)
    u = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    negc = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    neg = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros((B, W), dtype=torch.int32, device=dev)
    u1 = Wp // 4
    H1 = torch.where((u == u1) | (u == u1 - 1), 0, NEG).expand(B, W)
    H0 = torch.where(u == u1 - 1, 0, NEG).expand(B, W)
    H1 = H1.to(torch.int32).clone()
    H0 = H0.to(torch.int32).clone()
    E1 = neg.clone()
    F1 = neg.clone()
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = n.clone()
    bj = torch.zeros(B, dtype=torch.int32, device=dev)
    n1 = n[:, None]
    m1 = m[:, None]
    for d in range(2, dmax + 1):
        even = d % 2 == 0
        ap = AE if even else AO
        o = 2 * u + ap
        i = (d - o) // 2
        j = (d + o) // 2
        qc = _chars(q, n, (i - 1).expand(B, W).long(), QPAD)
        tc = _chars(t, m, (j - 1).expand(B, W).long(), TPAD)
        sub = torch.where(qc == tc, ma, mi)
        if even:
            # E parent (o-1, d-1) same lane; F parent (o+1, d-1) at u+1
            h_left, e_left = H1, E1
            h_up = torch.cat([H1[:, 1:], negc], dim=1)
            f_up = torch.cat([F1[:, 1:], negc], dim=1)
        else:
            # E parent at u-1; F parent same lane
            h_left = torch.cat([negc, H1[:, :-1]], dim=1)
            e_left = torch.cat([negc, E1[:, :-1]], dim=1)
            h_up, f_up = H1, F1
        e_open = h_left - go
        e_ext = e_left - ge
        E = torch.maximum(e_open, e_ext)
        e_opened = e_open >= e_ext
        f_open = h_up - go
        f_ext = f_up - ge
        F = torch.maximum(f_open, f_ext)
        f_opened = f_open >= f_ext
        diag = H0 + sub
        H = torch.maximum(torch.maximum(diag, E), F)
        hdir = torch.where(H == diag, H_DIAG,
                           torch.where(H == E, H_FROME, H_FROMF))
        on_b = ((o == d) | (o == -d)).expand(B, W)
        out_g = ((o > d) | (o < -d)).expand(B, W)
        H = torch.where(on_b, zero, H)
        hdir = torch.where(on_b, H_START, hdir)
        H = torch.where(out_g, neg, H)
        E = torch.where(out_g | on_b, neg, E)
        F = torch.where(out_g | on_b, neg, F)
        H = torch.clamp_min(H, NEG)
        E = torch.clamp_min(E, NEG)
        F = torch.clamp_min(F, NEG)
        dirs[:, d - 2, :] = (hdir | (e_opened.to(torch.int32) << 2)
                             | (f_opened.to(torch.int32) << 3)).to(torch.uint8)
        # endpoint candidates: last column (d - m, m), last row (n, d - n)
        for lane, ii, jj, lo in ((2 * m1 - d - ap, d - m1, m1, m1),
                                 (d - 2 * n1 - ap, n1, d - n1, n1)):
            uu = lane // 2
            ok = ((uu >= 0) & (uu < W) & (d >= lo) & (d <= n1 + m1))[:, 0]
            v = torch.gather(H, 1, uu.clamp(0, W - 1).long())[:, 0]
            ii = ii.expand(B, 1)[:, 0]
            jj = jj.expand(B, 1)[:, 0]
            upd = ok & ((v > best) | ((v == best) & (
                (ii > bi) | ((ii == bi) & (jj > bj)))))
            best = torch.where(upd, v, best)
            bi = torch.where(upd, ii, bi)
            bj = torch.where(upd, jj, bj)
        H0, H1, E1, F1 = H1, H, E, F
    return best, bi, bj, dirs


def sg_walk_plain(dirs: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor,
                  Wp: int, nops: int):
    """Plain version of K4: walk ``dirs`` back from (ei, ej).

    Returns ops uint8 [B, nops] (backward, contiguous, OP_NONE after the
    walk ends), fi, fj int32 [B] and overflow bool [B].  ``nops`` must be
    at least max(ei + ej) + 1.
    """
    dev = dirs.device
    B, S, W = dirs.shape
    _, AE, AO = band_consts(Wp)
    o_lo = AO
    i = ei.to(torch.int32).clone()
    j = ej.to(torch.int32).clone()
    st = torch.zeros(B, dtype=torch.int32, device=dev)
    ov = torch.zeros(B, dtype=torch.bool, device=dev)
    ops = torch.zeros((B, nops), dtype=torch.uint8, device=dev)
    flat = dirs.reshape(B, S * W)
    steps = int((i + j).max()) + 1 if B else 0
    for k in range(min(steps, nops)):
        active = (i > 0) & (j > 0) & (st != 3)
        d = i + j
        o = j - i
        ov = ov | (active & ((o <= o_lo) | (o >= o_lo + Wp - 1)))
        ap = torch.where(d % 2 == 0, AE, AO)
        uu = torch.div(o - ap, 2, rounding_mode="floor").clamp(0, W - 1)
        dd = (d - 2).clamp(0, S - 1)
        bits = torch.gather(flat, 1, (dd * W + uu)[:, None].long())[:, 0]
        bits = bits.to(torch.int32)
        hd = bits & 3
        e_opened = (bits & 4) != 0
        f_opened = (bits & 8) != 0
        in_h = st == 0
        hit_start = active & in_h & (hd == H_START)
        act_diag = active & in_h & (hd == H_DIAG)
        act_e = active & ((in_h & (hd == H_FROME)) | (st == 1))
        act_f = active & ((in_h & (hd == H_FROMF)) | (st == 2))
        op = torch.where(act_diag, OP_DIAG, torch.where(
            act_e, OP_GAPQ, torch.where(act_f, OP_GAPT, OP_NONE)))
        ops[:, k] = op.to(torch.uint8)
        ni = torch.where(act_diag | act_f, i - 1, i)
        nj = torch.where(act_diag | act_e, j - 1, j)
        nst = torch.where(act_diag, 0, torch.where(
            act_e, torch.where(e_opened, 0, 1),
            torch.where(act_f, torch.where(f_opened, 0, 2), st)))
        st = torch.where(hit_start, 3, nst).to(torch.int32)
        i, j = ni, nj
    return ops, i, j, ov


# the letter of each base code in the aligned rows (``encode.decode_seq``'s:
# A C G T N, X for any other code)
_ROW_LETTERS = torch.full((256,), ord("X"), dtype=torch.uint8)
for _code, _letter in enumerate("ACGTXN"):
    _ROW_LETTERS[_code] = ord(_letter)


def sg_rows_plain(ops: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor,
                  fi: torch.Tensor, fj: torch.Tensor, ov: torch.Tensor,
                  q: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
                  m: torch.Tensor, width: int):
    """Plain version of K4's epilogue: each walk's two aligned rows and its
    counts, the strings the JAX package's ``ops_to_alignment_counts``
    (``isocon_tpu/ops/affine.py``) builds from the walk

        a1 = "-" * fj + q[:fi] + mid1 + q[ei:] + "-" * (m - ej)
        a2 = t[:fj] + "-" * fi + mid2 + "-" * (n - ei) + t[ej:]

    as ASCII bytes (the codes' letters, ``_ROW_LETTERS``).  ops, fi, fj, ov:
    ``sg_walk_plain``'s outputs from (ei, ej); q, t: [B, Lp] codes, n, m
    their lengths.  Returns a1, a2 uint8 [B, width] (zero past each row's
    length), alen, nmat, nmis int32 [B] (the rows' length, matches and
    mismatches; the indels are alen - nmat - nmis); overflowed pairs get
    zeros.  ``width`` must be at least max(n + m)."""
    dev = ops.device
    L64 = lambda x: x.to(torch.int64)[:, None]
    ei, ej, fi, fj, n, m = (L64(x) for x in (ei, ej, fi, fj, n, m))
    k = (ops != OP_NONE).sum(1, keepdim=True)  # a final stop emits OP_NONE
    pos = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    p2 = fi + fj
    p3 = p2 + k
    p4 = p3 + (n - ei)
    alen = p4 + (m - ej)
    mid = (pos >= p2) & (pos < p3)
    # forward step pos - p2 of the mid is backward step p3 - 1 - pos
    back = (p3 - 1 - pos).clamp(0, ops.shape[1] - 1)
    op = torch.where(mid, torch.gather(ops.to(torch.int64), 1, back),
                     OP_NONE)
    uq = mid & (op != OP_GAPQ)               # consumes a query base
    ut = mid & (op != OP_GAPT)               # consumes a target base
    qi = fi + torch.cumsum(uq, 1) - 1
    ti = fj + torch.cumsum(ut, 1) - 1
    q_at = torch.where(pos < p2, pos - fj, torch.where(pos < p3, qi,
                                                       ei + pos - p3))
    t_at = torch.where(pos < fj, pos, torch.where(pos < p3, ti,
                                                  ej + pos - p4))
    q_used = ((pos >= fj) & (pos < p2)) | uq | ((pos >= p3) & (pos < p4))
    t_used = (pos < fj) | ut | ((pos >= p4) & (pos < alen))
    letters = _ROW_LETTERS.to(dev)
    dash = torch.tensor(ord("-"), dtype=torch.uint8, device=dev)

    def row(codes, at, used):
        Lp = codes.shape[1]
        c = torch.gather(codes.to(torch.int64), 1, at.clamp(0, Lp - 1))
        return torch.where(used, letters[c], dash)

    ov = ov.to(torch.bool)[:, None]
    live = (pos < alen) & ~ov
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    a1 = torch.where(live, row(q, q_at, q_used), zero)
    a2 = torch.where(live, row(t, t_at, t_used), zero)
    diag = live & mid & (op == OP_DIAG)
    nmat = (diag & (a1 == a2)).sum(1).to(torch.int32)
    nmis = (diag & (a1 != a2)).sum(1).to(torch.int32)
    alen = torch.where(ov, 0, alen)[:, 0].to(torch.int32)
    return a1, a2, alen, nmat, nmis


_DASH = np.uint8(ord("-"))


def respell_rows(a1: str, a2: str, q: str, t: str):
    """K4's aligned rows of q against t (``sg_rows_plain``'s) spelt with
    q's and t's own letters, and their (matches, mismatches, indels), the
    reference's triple (``SW_alignment_module.py:78-86``).  The rows'
    letters come from the base codes, which do not give back lowercase or
    letters other than A, C, G, T and N; a row's bytes other than its
    dashes are its sequence in order, so each takes the sequence's bytes
    there."""
    r1 = np.frombuffer(a1.encode("latin1"), dtype=np.uint8)
    r2 = np.frombuffer(a2.encode("latin1"), dtype=np.uint8)
    u1 = r1 != _DASH
    u2 = r2 != _DASH
    s1 = r1.copy()
    s2 = r2.copy()
    s1[u1] = np.frombuffer(q.encode("latin1"), dtype=np.uint8)
    s2[u2] = np.frombuffer(t.encode("latin1"), dtype=np.uint8)
    both = u1 & u2
    eq = s1 == s2
    matches = int((both & eq).sum())
    mismatches = int((both & ~eq).sum())
    return (s1.tobytes().decode("latin1"), s2.tobytes().decode("latin1"),
            (matches, mismatches, len(a1) - matches - mismatches))
