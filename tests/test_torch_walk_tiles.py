"""The tile rule of K4 (``csrc/affine_sg.cu``, the affine traceback walk)
on the CPU.

The kernel stages the direction bytes a walk reads in tiles of
``WALK_TILE_ROWS`` rows (diagonals) by ``WALK_TILE_ROWS + 16`` lanes,
anchored at the step that left the last tile, and reads every byte from
the staged tile.  ``tile_walk`` below does the same in Python, address
for address: it walks bytes taken from the staged tile only (rows not
staged hold a poison byte), checks each lane against the one (d, o)
gives, and records every (row, lane) read and every reload.
On dirs from ``sg_forward_plain`` it must give ``sg_walk_plain``'s
(ops, fi, fj, overflow) on every entry; no read may fall outside the tile
staged for it, no reload may come from the lane window (only from leaving
the tile's rows), and a pair loads at most ceil(S / TD) + 1 tiles.
Tolerance: exact (integer walk).
"""
import random

import numpy as np
import pytest
import torch

from isocon_tpu_torch.ops import affine as ta
from isocon_tpu_torch.ops.affine_cuda import WALK_TILE_ROWS
from isocon_tpu_torch.ops.encode import encode_seq
from test_torch_affine import _inputs
from test_torch_engine import _align_case

POISON = 0xF3      # never a direction byte K3 writes (bits 4-7 are 0)


def tile_walk(dirs, ei, ej, Wp, nops, TD=WALK_TILE_ROWS):
    """The kernel's walk with its tile addressing, step for step: a tile
    anchored where the walk left the last one, then steps inside it until
    the walk leaves it, ends or fills the 128-step opcode ring.  Returns
    (ops, fi, fj, ov) as ``sg_walk_plain`` does, and per pair the list of
    tiles, each (top row, first lane, [(row, lane) read]), and the reloads
    caused by the lane window alone."""
    B, S, W = dirs.shape
    WL = TD + 16
    _, AE, AO = ta.band_consts(Wp)
    o_lo = AO
    ring = 128
    ops = np.zeros((B, nops), np.uint8)
    fi = np.zeros(B, np.int32)
    fj = np.zeros(B, np.int32)
    ov = np.zeros(B, bool)
    tiles, lane_misses = [], []
    clamp_u = lambda x: min(max(x, 0), W - 1)
    for b in range(B):
        i, j, st, over = int(ei[b]), int(ej[b]), 0, False
        top, ulo, tile = -1, 0, None
        mine, lane_miss = [], 0
        k = 0
        active = i > 0 and j > 0
        while active and k < nops:
            o = j - i
            u = clamp_u((o - AE + 1) >> 1)
            dd = min(max(i + j - 2, 0), S - 1)
            if not (0 <= top - dd < TD and 0 <= u - ulo < WL):
                if 0 <= top - dd < TD:
                    lane_miss += 1
                top = dd
                ulo = min(max(u - TD // 2, 0) & ~15, W - WL)
                assert ulo >= 0 and ulo % 16 == 0 and ulo + WL <= W
                tile = np.full((TD, WL), POISON, np.uint8)
                r0 = top - TD + 1
                for row in range(max(r0, 0), top + 1):
                    tile[row - r0] = dirs[b, row, ulo:ulo + WL]
                tile = tile.reshape(-1)
                mine.append((top, ulo, []))
            ring_end = min((k | (ring - 1)) + 1, nops)
            while True:
                # the read, as the kernel addresses it and as (d, o) does
                ap = AO if (i + j) & 1 else AE
                assert u == clamp_u((o - ap) >> 1) and o == j - i
                mine[-1][2].append((dd, u))
                if o <= o_lo or o >= o_lo + Wp - 1:
                    over = True
                bits = int(tile[(dd - top + TD - 1) * WL + (u - ulo)])
                assert bits != POISON
                hd, e_op, f_op = bits & 3, bits & 4, bits & 8
                in_h = st == 0
                hit_start = in_h and hd == ta.H_START
                act_diag = in_h and hd == ta.H_DIAG
                act_e = (in_h and hd == ta.H_FROME) or st == 1
                act_f = (in_h and hd == ta.H_FROMF) or st == 2
                ops[b, k] = (ta.OP_DIAG if act_diag else ta.OP_GAPQ if act_e
                             else ta.OP_GAPT if act_f else ta.OP_NONE)
                i -= act_diag or act_f
                j -= act_diag or act_e
                st = (3 if hit_start else 0 if act_diag
                      else (0 if e_op else 1) if act_e
                      else (0 if f_op else 2) if act_f else st)
                k += 1
                active = i > 0 and j > 0 and st != 3
                o = j - i
                u = clamp_u((o - AE + 1) >> 1)
                dd = min(max(i + j - 2, 0), S - 1)
                if not (active and k < ring_end and 0 <= top - dd < TD
                        and 0 <= u - ulo < WL):
                    break
        fi[b], fj[b], ov[b] = i, j, over
        tiles.append(mine)
        lane_misses.append(lane_miss)
    return (ops, fi, fj, ov), tiles, lane_misses


def _walk_both(q, t, ql, tl, Wp, scores=None):
    """dirs of ``sg_forward_plain`` on code rows q/t; the tile walk and
    ``sg_walk_plain`` of them, held equal on every entry.  Returns the
    tile walk's (result, tiles, lane misses) and S."""
    B = q.shape[0]
    T = lambda x: torch.from_numpy(np.asarray(x, np.int32))
    if scores is None:
        scores = [(2, (-1, -2, -4)[b % 3], 2, (0, 1)[b % 2])
                  for b in range(B)]
    ma, mi, go, ge = (T([s[c] for s in scores]) for c in range(4))
    n, m = T(ql), T(tl)
    qt = torch.from_numpy(np.ascontiguousarray(q).view(np.uint8))
    tt = torch.from_numpy(np.ascontiguousarray(t).view(np.uint8))
    _best, ei, ej, dirs = ta.sg_forward_plain(qt, tt, n, m, ma, mi, go, ge,
                                              Wp)
    nops = int((n + m).max()) + 1
    want = ta.sg_walk_plain(dirs, ei, ej, Wp, nops)
    got, tiles, lane_misses = tile_walk(dirs.numpy(), ei.numpy(),
                                        ej.numpy(), Wp, nops)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    S = dirs.shape[1]
    return got, tiles, lane_misses, S


def _check_tiles(tiles, lane_misses, S, TD=WALK_TILE_ROWS):
    """Every read inside its tile's rows and lanes, every reload from
    leaving the rows, at most ceil(S / TD) + 1 tiles a pair."""
    WL = TD + 16
    assert not any(lane_misses)
    for mine in tiles:
        assert len(mine) <= -(-S // TD) + 1
        for top, ulo, reads in mine:
            for dd, u in reads:
                assert top - TD < dd <= top and dd >= 0
                assert ulo <= u < ulo + WL
        for (top, _, _), (nxt, _, _) in zip(mine, mine[1:]):
            assert nxt <= top - TD


def _encode(pairs, L):
    q = np.full((len(pairs), L), ta.QPAD, np.int8)
    t = np.full((len(pairs), L), ta.TPAD, np.int8)
    for b, (a, c) in enumerate(pairs):
        q[b, :len(a)] = encode_seq(a)
        t[b, :len(c)] = encode_seq(c)
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    tl = np.array([len(c) for _, c in pairs], np.int32)
    return q, t, ql, tl


@pytest.mark.parametrize("Wp,B,seed", [(256, 96, 11), (512, 32, 7)])
def test_tile_walk_matches_plain_walk(Wp, B, seed):
    """The affine tests' pairs (mutated, clipped, unrelated and shifted,
    some overflowing the 256 band)."""
    _pairs, q, qlen, t, tlen, *_ = _inputs(seed, B)
    got, tiles, lane_misses, S = _walk_both(q, t, qlen, tlen, Wp)
    _check_tiles(tiles, lane_misses, S)
    if Wp == 256:
        assert got[3].any()


@pytest.mark.parametrize("seed,drift", [(9, True), (5, False)])
def test_tile_walk_engine_pairs(seed, drift):
    """The engine tests' pairs at the first band, 256: with ``drift`` a
    200-base insertion then deletion (the path leaves the band in the
    middle, without touching its edge), else overlaps at offset +-128 on
    the band's edge, whose walks flag overflow."""
    pairs, scores = _align_case(seed, drift)
    L = max(max(len(a), len(b)) for a, b in pairs)
    q, t, ql, tl = _encode(pairs, -(-L // 8) * 8)
    got, tiles, lane_misses, S = _walk_both(q, t, ql, tl, 256, scores)
    _check_tiles(tiles, lane_misses, S)
    assert got[3].any() != drift


def _insertion_pair(seed, L0, ins, in_q=True):
    """A random core of L0 bases and a copy of it with ``ins`` random bases
    inserted at its middle: (query, target), the longer one the query if
    ``in_q``."""
    rng = random.Random(seed)
    core = "".join(rng.choice("ACGT") for _ in range(L0))
    extra = "".join(rng.choice("ACGT") for _ in range(ins))
    longer = core[:L0 // 2] + extra + core[L0 // 2:]
    return (longer, core) if in_q else (core, longer)


def test_tile_walk_planted_drift():
    """An insertion of 2 * WALK_TILE_ROWS bases in the query (the lane
    rises along the walk) or in the target (it falls), at band 512: along
    the walk's gap run u moves one lane every two diagonals across several
    tiles, up to the edge of a tile's lane window (TD / 2 lanes from its
    anchor), and the walk stays in the band."""
    TD = WALK_TILE_ROWS
    pairs = [_insertion_pair(s, 600, 2 * TD, in_q=s % 2 == 0)
             for s in range(4)]
    q, t, ql, tl = _encode(pairs, 736)
    got, tiles, lane_misses, S = _walk_both(q, t, ql, tl, 512,
                                            [(2, -4, 4, 1)] * len(pairs))
    _check_tiles(tiles, lane_misses, S)
    assert not got[3].any()
    for mine in tiles:
        drift = [max(abs(u - reads[0][1]) for _, u in reads)
                 for _, _, reads in mine]
        assert max(drift) >= TD // 2 - 1
        us = [u for _, _, reads in mine for _, u in reads]
        assert max(us) - min(us) >= TD      # the run crossed 2 * TD rows
        assert 0 < min(us) and max(us) < 255


def test_tile_walk_band_edges():
    """Band 256 (W = 128 lanes, offsets -127 .. 128): an insertion of 128
    bases in the target and of 127 in the query put the path on the band's
    last and first lane, where the walk flags overflow and the lane window
    is clipped to [W - WL, W) and [0, WL); insertions of 200 bases, longer
    than the half band, leave the best in-band path inside the band."""
    W, WL = 128, WALK_TILE_ROWS + 16
    pairs = [_insertion_pair(1, 600, 128, in_q=False),
             _insertion_pair(2, 600, 127),
             _insertion_pair(3, 600, 200, in_q=False),
             _insertion_pair(4, 600, 200)]
    q, t, ql, tl = _encode(pairs, 800)
    got, tiles, lane_misses, S = _walk_both(q, t, ql, tl, 256,
                                            [(2, -4, 4, 1)] * len(pairs))
    _check_tiles(tiles, lane_misses, S)
    assert got[3].tolist() == [True, True, False, False]
    for mine, edge, ulo in zip(tiles[:2], (W - 1, 0), (W - WL, 0)):
        us = [u for _, _, reads in mine for _, u in reads]
        assert us.count(edge) >= 200
        assert sum(t_ulo == ulo for _, t_ulo, _ in mine) >= 8
