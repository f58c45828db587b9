"""Port K3 + K4 (banded affine semi-global forward DP and traceback walk)
vs the JAX package.

The plain PyTorch versions (``isocon_tpu_torch.ops.affine``, reached
through ``affine_cuda.sg_align_pool`` on CPU tensors) must equal the
lax.scan reference ``sg_align_with_ops`` and the compacted Pallas kernels
in interpret mode: score, endpoint, start point, overflow flag and
decoded alignment on every pair, those that overflow the band included.
K4's aligned rows (``sg_rows_plain``) must spell, pair by pair, the
strings and counts the JAX package's ``ops_to_alignment_counts`` decodes
from the walk.
The CUDA kernels are held to the plain versions in test_torch_cuda.py.
Tolerance: exact (integer DP).
"""
import random

import numpy as np
import pytest
import torch

from isocon_tpu.ops.affine import (ops_to_alignment, ops_to_alignment_counts,
                                   sg_align_with_ops)
from isocon_tpu.ops.affine_pallas_c import sg_align_with_ops_pallas_c
from isocon_tpu.ops.encode import pad_batch
from isocon_tpu_torch.ops import affine as ta
from isocon_tpu_torch.ops import affine_cuda as tac
from isocon_tpu_torch.ops.engine import pool_from_numpy

L = 256


def make_pairs(rng, B, L):
    """Mutated, clipped, unrelated and shifted pairs; the shifted ones
    (offset past the half band) overflow a 256-wide band."""
    def rs(n):
        return "".join(rng.choice("ACGTN" if n % 7 == 0 else "ACGT")
                       for _ in range(n))

    def mut(s, k):
        s = list(s)
        for _ in range(k):
            op = rng.choice("SID")
            p = rng.randrange(len(s))
            if op == "S":
                s[p] = rng.choice("ACGT")
            elif op == "I" and len(s) < L - 1:
                s.insert(p, rng.choice("ACGT"))
            elif len(s) > 2:
                del s[p]
        return "".join(s)

    pairs = []
    for i in range(B):
        a = rs(rng.randrange(60, L - 60))
        if i % 6 == 0:
            b = rs(rng.randrange(60, L - 60))            # unrelated
        elif i % 6 == 1:
            b = a[rng.randrange(0, 20):][:max(10, len(a) - rng.randrange(0, 20))]
            b = mut(b, rng.randrange(0, 6))              # clipped ends
        elif i % 6 == 2:
            core = rs(rng.randrange(60, 100))            # shifted overlap
            a = rs(130) + core
            b = mut(core, 2) + rs(rng.randrange(0, 60))
        else:
            b = mut(a, rng.randrange(0, 25))
        pairs.append((a, b))
    return pairs


def _inputs(seed, B):
    pairs = make_pairs(random.Random(seed), B, L)
    q, qlen = pad_batch([a for a, _ in pairs], L)
    t, tlen = pad_batch([b for _, b in pairs], L)
    ma = np.full(B, 2, np.int16)
    mi = np.array([(-1, -2, -4)[i % 3] for i in range(B)], np.int16)
    go = np.full(B, 2, np.int16)
    ge = np.array([0, 1] * (B // 2), np.int16)
    return pairs, q, qlen, t, tlen, ma, mi, go, ge


def _port(q, qlen, t, tlen, ma, mi, go, ge, Wp, device="cpu"):
    B = q.shape[0]
    pool, plen = pool_from_numpy(np.concatenate([q, t]).reshape(-1),
                                 np.concatenate([qlen, tlen]), L, device)
    ia = torch.arange(B, dtype=torch.int32, device=device)
    T = lambda x: torch.from_numpy(x.astype(np.int32)).to(device)
    return tac.sg_align_pool(pool, plen, ia, ia + B, T(ma), T(mi), T(go),
                             T(ge), Wp=Wp)


def _rows_of(a1, a2, alen, nmat, nmis, k):
    """Pair k's (s1, s2, (matches, mismatches, indels)) from K4's rows."""
    A, ma, mi = int(alen[k]), int(nmat[k]), int(nmis[k])
    assert not np.asarray(a1[k, A:]).any() and not np.asarray(a2[k, A:]).any()
    return (bytes(np.asarray(a1[k, :A])).decode("latin1"),
            bytes(np.asarray(a2[k, :A])).decode("latin1"),
            (ma, mi, A - ma - mi))


def _check(pairs, ref, got):
    r_best, r_ei, r_ej, r_ops, r_fi, r_fj, r_ov = [np.asarray(x) for x in ref]
    g_best, g_ei, g_ej, g_ops, g_fi, g_fj, g_ov = [x.numpy() for x in got[:7]]
    a1, a2, alen, nmat, nmis = [x.numpy() for x in got[7:12]]
    np.testing.assert_array_equal(g_ov, r_ov)
    np.testing.assert_array_equal(g_best, r_best)
    np.testing.assert_array_equal(g_ei, r_ei)
    np.testing.assert_array_equal(g_ej, r_ej)
    np.testing.assert_array_equal(g_fi, r_fi)
    np.testing.assert_array_equal(g_fj, r_fj)
    for i in range(len(pairs)):
        a, b = pairs[i]
        want = ops_to_alignment(r_ops[i], a, b, int(r_ei[i]), int(r_ej[i]),
                                int(r_fi[i]), int(r_fj[i]))
        have = ops_to_alignment(g_ops[i], a, b, int(g_ei[i]), int(g_ej[i]),
                                int(g_fi[i]), int(g_fj[i]))
        assert have == want, i
        if g_ov[i]:
            assert alen[i] == nmat[i] == nmis[i] == 0 and not a1[i].any()
        else:
            assert _rows_of(a1, a2, alen, nmat, nmis, i) == \
                ops_to_alignment_counts(g_ops[i], a, b, int(g_ei[i]),
                                        int(g_ej[i]), int(g_fi[i]),
                                        int(g_fj[i])), i
    return int(r_ov.sum())


@pytest.mark.parametrize("Wp,B,seed", [(256, 96, 11), (512, 32, 7)])
def test_plain_matches_scan(Wp, B, seed):
    pairs, q, qlen, t, tlen, ma, mi, go, ge = _inputs(seed, B)
    ref = sg_align_with_ops(q, t, qlen, tlen, ma, mi, go, ge, Wp=Wp, L=L)
    got = _port(q, qlen, t, tlen, ma, mi, go, ge, Wp)
    n_ov = _check(pairs, ref, got)
    if Wp == 256:
        assert 0 < n_ov < B  # the shifted pairs overflow the 256 band


@pytest.mark.parametrize("Wp,B,seed", [(256, 64, 13), (512, 32, 17)])
def test_plain_matches_pallas_interpret(Wp, B, seed):
    pairs, q, qlen, t, tlen, ma, mi, go, ge = _inputs(seed, B)
    ref = sg_align_with_ops_pallas_c(q, t, qlen, tlen, ma, mi, go, ge,
                                     Wp=Wp, L=L, interpret=True)
    got = _port(q, qlen, t, tlen, ma, mi, go, ge, Wp)
    _check(pairs, ref, got)


def _walks(pairs, Wp, mismatch=None):
    """Codes, lengths and the plain K3 + K4 walk of ``pairs`` at band Wp
    (match 2, open 2, extend 0 / 1 in turn; mismatch -1 / -2 / -4 in turn
    unless given)."""
    B = len(pairs)
    Lw = max(max(len(a), len(b)) for a, b in pairs)
    q, qlen = pad_batch([a for a, _ in pairs], Lw)
    t, tlen = pad_batch([b for _, b in pairs], Lw)
    T = lambda x: torch.from_numpy(np.asarray(x, np.int32))
    mi = [(-1, -2, -4)[i % 3] for i in range(B)] if mismatch is None \
        else [mismatch] * B
    q, t, n, m = (torch.from_numpy(x) for x in (q, t, qlen, tlen))
    best, ei, ej, dirs = ta.sg_forward_plain(
        q, t, n, m, T([2] * B), T(mi), T([2] * B), T([i % 2 for i in
                                                     range(B)]), Wp)
    nops = int((n + m).max()) + 1
    ops, fi, fj, ov = ta.sg_walk_plain(dirs, ei, ej, Wp, nops)
    return q, t, n, m, ops, ei, ej, fi, fj, ov


def _synthetic_walks(rng, op, B):
    """Walks of one opcode only (OP_GAPQ: insertions in the target, OP_GAPT:
    deletions from it), of 1 .. 60 steps, ending anywhere inside random
    pairs."""
    pairs, rows = [], []
    for _ in range(B):
        a, b = _rand(rng, rng.randrange(1, 200)), _rand(rng, rng.randrange(
            1, 200))
        g = rng.randrange(1, 61)
        if op == ta.OP_GAPQ:
            b += _rand(rng, g)
            ei = rng.randrange(0, len(a) + 1)
            ej = rng.randrange(g, len(b) + 1)
            fi, fj = ei, ej - g
        else:
            a += _rand(rng, g)
            ei = rng.randrange(g, len(a) + 1)
            ej = rng.randrange(0, len(b) + 1)
            fi, fj = ei - g, ej
        pairs.append((a, b))
        rows.append((g, ei, ej, fi, fj))
    L = max(max(len(a), len(b)) for a, b in pairs)
    q, qlen = pad_batch([a for a, _ in pairs], L)
    t, tlen = pad_batch([b for _, b in pairs], L)
    ops = torch.zeros((B, 2 * L + 1), dtype=torch.uint8)
    for k, (g, *_e) in enumerate(rows):
        ops[k, :g] = op
    ei, ej, fi, fj = (torch.tensor(c, dtype=torch.int32)
                      for c in zip(*[r[1:] for r in rows]))
    return pairs, (torch.from_numpy(q), torch.from_numpy(t),
                   torch.from_numpy(qlen), torch.from_numpy(tlen), ops, ei,
                   ej, fi, fj, torch.zeros(B, dtype=torch.bool))


def _rand(rng, k, alphabet="ACGT"):
    return "".join(rng.choice(alphabet) for _ in range(k))


def _rows_case(kind):
    """(pairs, walk) of one kind; walk as ``_walks`` returns it."""
    rng = random.Random(kind)
    if kind.startswith("wp"):
        # mutated, clipped (end gaps on either side), unrelated, shifted;
        # B x Wp/2 under torch's intra-op grain (32,768 elements), so that
        # the plain DP runs one thread a worker
        Wp = int(kind[2:])
        pairs = make_pairs(rng, 24 if Wp < 2048 else 12, L)
        pairs += [(b, a) for a, b in pairs[:len(pairs) // 2]]
        return pairs, _walks(pairs, Wp)
    if kind == "empty_mid":
        # no positive cell: the endpoint is (n, 0) and the walk takes no step
        pairs = [("A" * rng.randrange(1, 90), "C" * rng.randrange(1, 90))
                 for _ in range(8)]
        walk = _walks(pairs, 256, mismatch=-4)
        assert not walk[4].any()
        return pairs, walk
    if kind in ("insertion", "deletion"):
        return _synthetic_walks(rng, ta.OP_GAPQ if kind == "insertion"
                                else ta.OP_GAPT, 16)
    if kind == "n_bases":
        pairs = []
        for _ in range(16):
            a = _rand(rng, rng.randrange(40, 200), "ACGTNN")
            b = "".join(c if rng.random() > 0.1 else rng.choice("ACGTN")
                        for c in a[rng.randrange(0, 20):])
            pairs.append((a, b))
        return pairs, _walks(pairs, 256)
    if kind == "respelt":
        # lowercase and IUPAC letters, which the rows spell as the codes'
        # letters: ``respell_rows`` gives them back
        pairs = []
        for _ in range(16):
            a = _rand(rng, rng.randrange(40, 200), "ACGTNacgtnRYKM")
            b = "".join(c if rng.random() > 0.1 else rng.choice("ACGTacgtSW")
                        for c in a[rng.randrange(0, 20):])
            pairs.append((a, b))
        return pairs, _walks(pairs, 256)
    assert kind == "ragged"
    pairs = []
    for n in (1, 2, 1, 40, 7, 230, 3, 120):
        a = _rand(rng, n)
        pairs.append((a, a[: max(1, n // 2)] + _rand(rng, rng.randrange(0, 5))))
        pairs.append((_rand(rng, rng.randrange(1, 4)), a))
    return pairs, _walks(pairs, 256)


@pytest.mark.parametrize("kind", ["wp256", "wp512", "wp1024", "wp2048",
                                  "empty_mid", "insertion", "deletion",
                                  "n_bases", "ragged", "respelt"])
def test_rows_plain_match_host_decode(kind):
    """``sg_rows_plain`` (K4's epilogue) against the JAX package's
    ``ops_to_alignment_counts`` on every pair: both strings, byte for
    byte, and the counts (``respelt``: those of ``respell_rows``, which
    spells the rows with the pairs' own letters); the rows past their
    length, and the rows of overflowed pairs, are zeros."""
    pairs, (q, t, n, m, ops, ei, ej, fi, fj, ov) = _rows_case(kind)
    width = int((n + m).max()) + 3
    a1, a2, alen, nmat, nmis = ta.sg_rows_plain(ops, ei, ej, fi, fj, ov, q,
                                                t, n, m, width)
    assert a1.shape == a2.shape == (len(pairs), width)
    assert a1.dtype == torch.uint8 and alen.dtype == torch.int32
    a1, a2, alen, nmat, nmis = (x.numpy() for x in (a1, a2, alen, nmat,
                                                    nmis))
    decoded = 0
    for k, (a, b) in enumerate(pairs):
        if ov[k]:
            assert alen[k] == nmat[k] == nmis[k] == 0
            assert not a1[k].any() and not a2[k].any()
            continue
        want = ops_to_alignment_counts(
            ops[k].numpy(), a, b, int(ei[k]), int(ej[k]), int(fi[k]),
            int(fj[k]))
        have = _rows_of(a1, a2, alen, nmat, nmis, k)
        if kind == "respelt":
            have = ta.respell_rows(have[0], have[1], a, b)
        assert have == want, k
        decoded += 1
    assert decoded >= len(pairs) // 2
