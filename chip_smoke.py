#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``isocon_tpu_torch``).

On one NVIDIA GPU (sm_90a) this script

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
2. builds the port's CUDA kernels from ``isocon_tpu_torch/csrc`` with nvcc
   and the host traceback library with g++, and prints the build seconds
   and ptxas' register / shared-memory / spill report (and the registers
   and spills of K3's register kernel per band, of K5's per band and
   mode and of K1's and K2's band kernel per window);
3. holds every kernel against its plain PyTorch version on the card, at
   the main path's shapes, with exact equality on every entry (K1-K5's
   outputs are integer DP results, K6's float32 sums in a fixed order):
   K1 (banded Myers ED) and K2 (HW-mode / infix Myers: distance and end
   column) at L = 2048 for windows 7, 9, 17, 33
   and the full width on 4096 seeded pairs each, K2's certified entries
   also against the numpy oracle on a sample; K3 + K4 (affine forward +
   traceback walk) at L = 2048, bands 256, 512 and 1024 (every band of
   K3's register kernel, on 512, 264 and 100 pairs: one and four warps a
   pair) and 2048 (its block kernel), on seeded pairs of which
   some overflow; K5 (banded wavefront ED, NW and HW:
   distance and end column) at L = 32,768 for bands 128 and 256 and at
   L = 2048 for bands 256, 512, 1024 (every band of its register kernel)
   and 2048 (its wide kernel), on seeded pairs that hold uncertified,
   clamped and out-of-band pairs, queries longer than their target, empty
   spans and lengths 0 and 1, certified entries also against the numpy
   oracle on a sample; K6 (the sketch scores of ``--nontargeted``,
   sequential-FMA sums, and each row's top 20): its scores entry bit for
   bit on every entry of the [N, N] matrix, launched in row chunks against
   the plain version in the same chunks on the card, and their top-20
   lists, and its fused top-20 (the first pass, the merge and both) on
   every row, values bit for bit and indices, at N = 2,000 and 10,001 on
   seeded profiles with exact ties and on the first round's real profiles
   of the nontargeted workload; in the timing phase once more at the
   timed shapes:
   K1 and K2 on the engine's chunk of 262,144 pairs at win 7, K2 on the
   10k run's own launches (the static graph of its phase-1 candidates,
   ``time_static_graph``), K5 on the
   engine's chunk of 16,384 pairs at bands 128 and 256, K3 + K4
   on the whole 8192-pair batch (band 256, L = 2048) and at the long run's
   shape (band 512, L = 32,768) on a slice of the timed batch, K3/K4 at
   the runs' mean launch sizes against their launch at the table shape;
   MAM correction's consensus chain (vote and correction, ``phase_check_
   consensus``) on every output, the rows up to their length, at a
   targeted round's and a long round's shape (``CONSENSUS_SHAPES``),
   timed, its plain version on the CPU;
   then ``phase_engine_routes``, the engine's host route (the CPU's, which
   the card never takes) against the card's kernels, every entry equal:
   (a) ``native.myers_ed_batch_k`` against K1 at the full window on the
   4,096 K1 pairs under four kinds of cap, and against the card engine's
   K5 route on 64 long pairs; (b) ``native.hw_traceback_batch(band=64)``
   with caps against K2 at the full window; (c) a CPU engine against a
   card engine on 4,000 real NN-search pairs of the 10k workload, NW and
   HW, entries and counters; (d) the JAX engine's small-round route (64
   NW or 256 HW pairs to the host) timed against the card's round trip,
   in turns: readings only;
4. runs ``pipeline`` (phase 1, ``get_candidates``, then phase 2,
   ``stat_filter``) through ``isocon_tpu_torch.cli`` on the card on the
   10,000-read workload (``isocon_tpu_torch.workload``), with every kernel
   launch counter set to 0 just before and read at the phase boundary and
   just after, and holds ``candidates_converged.fa``,
   ``final_candidates.fa`` and ``cluster_info.tsv`` to the sha256 the JAX
   package gives on the CPU, and the engine's ED and alignment volume at
   the end of each phase and the number of survivors of the HW prefilter
   to the JAX package's (``isocon_tpu_torch/smoke_expect.json``), and keeps
   its ``candidates_converged.fa`` for the static graph's K2 step; then the
   same for the long-read workload (500 reads of 16.5-20 kb, every pair
   in the 32,768-wide bucket, where the edit distances run K5), against
   the ``"long"`` block of the same file; then ``pipeline --nontargeted``
   on the 10,000 reads of four gene families (104 isoforms), where K6
   scores each phase-1 round and K1 rescores the pairs it names with no
   cap, against the ``"nontargeted"`` block (K7 launched once a sketch
   call, for every row); each run fails if its
   engine has ``native_cpu`` set or if its ``max_memory_allocated``
   exceeds ``PEAK_BYTES`` by more than 2%;
5. times each kernel and its plain version with CUDA events at the main
   path's shapes and computes each kernel's bound (``bound_ms``; K4's is
   also bounded by the chain of its longest walk); K2 on the 262,144-pair
   chunk and on each launch of the 10k run's static graph, whose sum the
   ``kernels`` line gives (at most ``STATIC_GRAPH_SECONDS`` for the step),
   each with its columns, ``warp_balance`` and the share of warp phases in
   which its vote fires; also K5 at band 256,
   K3/K4 at the long run's shape and K3/K4 at the runs' mean launch sizes
   (917 pairs at band 256, L = 2048; 119 at band 512, L = 32,768), without
   timing their plain versions; K6 at N = 10,000 (the nontargeted run's
   first round) and at N = 1,102 (its smallest round's size, the first
   1,102 of those reads): the fused top-20 against the path it replaced
   (the scores entry in 4,096-row chunks and a stable sort), in turns, its
   first pass, its merge and the scores entry alone, with their plain
   versions and, as yardsticks only, the library calls (``torch.matmul``
   without TF32 and ``torch.topk``: ``library_ms``); K7 (the sketch's
   square-rooted k-mer profiles, ``time_kmer_profile``) on job 0 of the
   benchmark cell ``nontargeted_pipeline`` (10,000 reads, mean ~1,166
   bases, round 1's shape) and on its first 1,102 reads (a later
   round's), held bit for bit to its plain version, beside its bytes
   bound, the plain version's time and the per-read ``kmer_profile`` loop
   it replaced;
6. prints one JSON line with the kernels, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

Any failed phase raises, and the script then exits non-zero without the
last line; it also fails without a CUDA device.  The script re-runs itself
with PYTHONHASHSEED=0 (see ``pin_hash_seed``).

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_READS = 10000                 # the 10k-read workloads of phase 4
NONTARGETED_FAMILIES = 4        # gene families of the nontargeted one
SMALLEST_ROUND = 1102           # its smallest sketch round's unique reads
KMER_PROFILE_SEED = 2148640001  # K7's timed reads: this seed's job 0

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
SMS = 132
INT32_LANES_PER_SM = 64
# float32 FMA lanes an SM (4 x 32): 132 x 128 x 2 flops x 1,980 MHz is the
# published 67 TFLOP/s of float32 outside the tensor cores
FP32_LANES_PER_SM = 128
# K6, per output: the sketch sum's D fmas (one each, on the FP32 pipe), and
# the two subtractions (length difference, diagonal) counted in every
# entry; the length difference's integer abs and conversion not counted
SKETCH_OPS_PER_OUTPUT = 2
# 32-bit operations of the recurrences, index arithmetic not counted.
# Myers, per window word and text column, with the fused forms sm_90 has
# (three-input LOP3, the funnel shift SHF.L.W that gives (cur << 1) |
# (prev >> 31) in one instruction), counted per pipe.  An SM's ALU pipe
# (LOP3, shifts, compares, selects) takes 64 lanes a clock, its FMA pipe
# another 64 for the integer multiply-adds (IMAD and its forms), and it
# issues 128 lanes a clock in all; shared loads go to the load/store unit
# and are not counted.  ALU only, the bit logic: Eq | carry 1, & Pv 1, Xh 1
# (one LOP3, (sum ^ Pv) | Eq), Ph 1 (one LOP3, Mv | ~(Xh | Pv)), Mh 1, Pv 2
# (Mh' | ~(Eq | Mv | Ph'), four inputs), Mv 1 (one LOP3, Ph' & (Eq | Mv)).
# Either pipe: + Pv 1, the carry bit of the previous word's Mh 1 (a shift,
# or IMAD.HI of x and 2), the two shifted words 2 (a funnel shift each, or
# x * 2 + carry in an IMAD).  Their IMAD forms take up to 7 FMA slots a
# word, under the ALU's 8, so a kernel could run at the ALU term.  Not
# counted: the Peq load (a shared load).  Earlier counts: 20 as written
# (Xh 4, Ph 3, Pv 3, the carries 6: two shifts out, two shifts in, two
# ors), then 13 with every operation and the Peq load at the ALU's rate.
MYERS_ALU_OPS_PER_WORD = 8
MYERS_ANY_OPS_PER_WORD = 4
# Per text column: the Peq slot of the column's code 1 (an address,
# code x stride + base, on either pipe); the code itself is a shared load.
# K1 needs nothing else a column: the answer D'[n][m] is read once from the
# banded table (the row above the window and the vertical sum down to row
# n, popcounts), where the TPU kernel sums the diagonal's four delta bits
# and row n's walk every column.  Not counted, because they come once a
# phase of 32 columns or once a pair: those popcounts, the window's shift
# and the staging copies.
MYERS_ANY_OPS_PER_COLUMN = 1
# K2's row-n walk, per column where row n's word is in the window.  ALU
# only: the two delta bits' masks 2, the running minimum's three compares
# chained through one predicate 3 and its two selects 2.  Either pipe: the
# delta bits' two shifts 2 and the walk's add 1.  Earlier counts: 15 (the
# bits' difference apart, the compares' two ands as written and a latch of
# the walk at column n, which the anchor read from the table replaces, on
# every column), then 10 at the ALU's rate.
MYERS_HW_WALK_ALU_OPS_PER_COLUMN = 7
MYERS_HW_WALK_ANY_OPS_PER_COLUMN = 3
# Affine, per band cell of the steady diagonals, with the fused forms sm_90
# has (DPX add-max and max of three, three-input LOP3): substitution score
# 2 (code compare, select of match or mismatch), diagonal add 1, E 3 (open
# subtract, extend-or-open as one add-max max(e - ext, h - open), opened
# compare E == open, which is open >= extend), F 3 (the same), H 1 (max of
# three of the unfloored diagonal, E and F), direction code 4 (H == diagonal
# and H == E compares, two selects), direction byte 3 (the two opened bits
# selected, one three-input LOP3 joining them to the code), NEG floors 3
# (H, E, F).  Per diagonal, not per cell: the pad test of the one code that
# enters it (compare, select).  Not counted, because the function does not
# need them in every cell: the boundary rules (row 0, column 0 and the cells
# outside the grid lie in the band only on the first Wp/2 diagonals), the
# endpoint's compare over the column-m and row-n cells (at most Wp/2 + 1 of
# each a pair) and any guard of an implementation.  An earlier count of 26
# took each operation as written (E and F 4 each, H 2, the byte 4 with its
# shifts and ors) and added a band-edge start test in every cell.
AFFINE_OPS_PER_CELL = 20
AFFINE_OPS_PER_DIAGONAL = 2
# Walk, per step: loop test 3, (d, o) 2, overflow test 2, lane and
# diagonal index 4, direction bits 3, state and coordinate update 2.
WALK_OPS_PER_STEP = 16
# The walk is a chain: each step's direction byte picks the next step's
# address, so a pair takes at least its steps times the latency of one
# dependent load from shared memory (where K4 stages the bytes).  About 30
# cycles on Hopper: Luo et al., "Benchmarking and Dissecting the Nvidia
# Hopper GPU Architecture" (2024), shared-memory load latency of the H800.
SHARED_LOAD_CYCLES = 30
# Wavefront, per DP cell (Wp/2 a diagonal), with the min-plus forms the
# card has (sm_90's DPX instructions; their rate is not published, and it
# is taken as the integer rate): the minimum of the two neighbours and the
# diagonal 1 (min(a, b, c)), the code compare 1, the choice of the
# diagonal or the ceiling 1, and the add-min 1 (min(a + 1, b));
# min(min(up, down) + 1, diag + (q != t)) capped at the ceiling is
# min(min(up, down, diag) + 1, q == t ? diag : ceiling) for
# diag <= ceiling.  Written out without DPX it is 6.  Per diagonal, not per
# cell: the pad test of the one code that enters it (compare, select).
# Not counted, because the function does not need them in every cell: the
# grid's boundary (only the first Wp/2 of some 36,500 diagonals can touch
# it) and any guard of an implementation.
# HW adds, per diagonal, the strict minimum over the one cell of row n:
# compare, select.
WAVEFRONT_OPS_PER_CELL = 4
WAVEFRONT_OPS_PER_DIAGONAL = 2
WAVEFRONT_HW_OPS_PER_DIAGONAL = 2

T0 = time.perf_counter()


def log(msg: str) -> None:
    print("[%7.1fs] %s" % (time.perf_counter() - T0, msg), flush=True)


def bound_ms(nbytes, ops, clock_mhz, chain_steps=0,
             lanes=INT32_LANES_PER_SM):
    """(least time in ms, "bytes", "operations" or "chain"): the largest of
    the bytes a function must move over 3.35 TB/s, its operations over 132
    SMs x ``lanes`` x the SM clock (int32: 64 lanes, K1's and K2's counted
    per pipe, ``myers_work``; float32 FMA: 128) and, for a chain of
    dependent steps (K4's longest walk), its steps x ``SHARED_LOAD_CYCLES``
    at the SM clock."""
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": ops / (SMS * lanes * clock_mhz * 1e6) * 1e3,
        "chain": chain_steps * SHARED_LOAD_CYCLES / (clock_mhz * 1e6) * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------
def _mutate(rs, np, a, div, alpha):
    """Substitutions, insertions and deletions at total rate ``div``."""
    r = rs.random(a.size)
    sub = r < div / 3
    ins = (r >= div / 3) & (r < 2 * div / 3)
    dele = (r >= 2 * div / 3) & (r < div)
    a = np.where(sub, rs.choice(alpha, size=a.size), a)
    reps = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(a, reps)
    # the second copy of an inserted position becomes a random code
    first = np.concatenate([[0], np.cumsum(reps)[:-1]])
    extra = first[ins] + 1
    out[extra] = rs.choice(alpha, size=extra.size)
    return out


def myers_pairs(np, B, L, seed=1):
    """K1 pairs: divergence 0-40%, N codes, length deltas up to 600."""
    rs = np.random.default_rng(seed)
    alpha = np.array([0, 1, 2, 3, 5], np.uint8)
    q = np.full((B, L), 6, np.uint8)
    t = np.full((B, L), 6, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rs.integers(600, L + 1))
        a = rs.choice(alpha, size=n, p=[.24, .24, .24, .24, .04])
        o = _mutate(rs, np, a, rs.uniform(0, 0.4), alpha)
        d = int(rs.integers(-600, 601))
        if d > 0:
            o = np.concatenate([o, rs.choice(alpha, size=d)])
        elif d < 0:
            o = o[:max(1, o.size + d)]
        o = o[:L]
        q[b, :n] = a
        t[b, :o.size] = o
        ql[b] = n
        tl[b] = o.size
    return q, t, ql, tl


def hw_pairs(np, B, L, seed=3):
    """K2 pairs (query, target): exact substrings, mutated substrings,
    queries longer than the target, comparable noisy pairs, unrelated
    pairs and queries of 1-11 codes."""
    rs = np.random.default_rng(seed)
    alpha = np.array([0, 1, 2, 3, 5], np.uint8)
    q = np.full((B, L), 6, np.uint8)
    t = np.full((B, L), 6, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rs.integers(600, L - 60))
        tgt = rs.choice(alpha, size=m, p=[.24, .24, .24, .24, .04])
        lo, hi = sorted(int(x) for x in rs.integers(0, m, 2))
        mode = b % 6
        if mode == 0:
            a = tgt[lo:hi + 1]
        elif mode == 1:
            a = _mutate(rs, np, tgt[lo:hi + 1], rs.uniform(0, 0.05), alpha)
        elif mode == 2:
            a = _mutate(rs, np, np.concatenate(
                [tgt, rs.choice(alpha, size=int(rs.integers(1, 50)))]),
                rs.uniform(0, 0.01), alpha)
        elif mode == 3:
            a = _mutate(rs, np, tgt, rs.uniform(0, 0.06), alpha)
        elif mode == 4:
            a = rs.choice(alpha, size=int(rs.integers(40, L)))
        else:
            a = rs.choice(alpha, size=int(rs.integers(1, 12)))
        a = a[:L] if a.size else tgt[:5]
        q[b, :a.size] = a
        t[b, :m] = tgt
        ql[b] = a.size
        tl[b] = m
    return q, t, ql, tl


HW_WARP_KINDS = ("query", "mixed", "longq", "short", "early", "edges")


def hw_warp_pairs(np, L, kinds=HW_WARP_KINDS, seed=8, tail=5):
    """K2 pairs (query, target) in warps of 32 consecutive lanes, one warp
    of each kind in ``kinds``, then ``tail`` lanes of a one-query warp (a
    ragged last warp):
    - "query": one query of 2L/3 to L - 20 codes against targets within 40
      codes of its length, noisy copies cut or extended at the ends, one in
      eight unrelated: the static graph's warps, whose lanes walk in the
      same phases;
    - "mixed": lengths drawn apart, as ``hw_pairs``' warps: substrings of
      the target, noisy copies, unrelated pairs;
    - "longq": every other lane a query 129 or more codes longer than its
      target (the anchor would be read after column m), the others mixed;
    - "short": queries of 1-32 codes against targets of 0 and 1 codes (the
      first 8 lanes) or up to L;
    - "early": one lane of n = m = L, the others ending in the first
      phases (queries of 1-32 codes, or targets of at most 64);
    - "edges": lengths 0, 1 and L on either side.
    Rows are padded with code 6 past their length, but every fourth row
    with codes that would match there.  Returns (q, t, ql, tl) as uint8
    [B, L] planes and int32 lengths."""
    rs = np.random.default_rng(seed)
    alpha = np.array([0, 1, 2, 3, 5], np.uint8)
    rand = lambda k: rs.choice(alpha, size=k, p=[.24, .24, .24, .24, .04])
    edges = [(0, 0), (0, 1), (1, 0), (1, 1), (0, L), (L, 0), (1, L),
             (L, 1), (L, L), (L, L - 1), (L - 1, L), (32, 0), (33, 1)]

    def mixed(i):
        m = int(rs.integers(1, L + 1))
        tgt = rand(m)
        lo, hi = sorted(int(x) for x in rs.integers(0, m, 2))
        mode = i % 4
        if mode == 0:
            return tgt[lo:hi + 1], tgt
        if mode == 1:
            return _mutate(rs, np, tgt[lo:hi + 1], 0.05, alpha), tgt
        if mode == 2:
            return _mutate(rs, np, tgt, 0.03, alpha), tgt
        return rand(int(rs.integers(1, L + 1))), tgt

    def query_warp(lanes):
        qry = rand(int(rs.integers(2 * L // 3, L - 19)))
        out = []
        for i in range(lanes):
            o = _mutate(rs, np, qry, rs.uniform(0, 0.03), alpha)
            a, b = (int(x) for x in rs.integers(-20, 21, 2))
            o = np.concatenate([rand(max(-a, 0)), o[max(a, 0):]])
            o = np.concatenate([o[:o.size - max(b, 0)], rand(max(-b, 0))])
            if i % 8 == 7:
                o = rand(o.size)
            out.append((qry, o))
        return out

    lanes = []
    for kind in kinds:
        if kind == "query":
            lanes += query_warp(32)
            continue
        for i in range(32):
            if kind == "mixed" or (kind == "longq" and i % 2):
                a, o = mixed(i)
            elif kind == "longq":
                o = rand(int(rs.integers(1, L - 129)))
                n = int(rs.integers(o.size + 129, L + 1))
                a = np.concatenate([_mutate(rs, np, o, 0.02, alpha),
                                    rand(n)])[:n]
            elif kind == "short":
                o = rand(i % 2 if i < 8 else int(rs.integers(0, L + 1)))
                a = rand(int(rs.integers(1, 33)))
            elif kind == "early" and i == 0:    # substitutions only
                o = rand(L)
                a = np.where(rs.random(L) < 0.02, rand(L), o)
            elif kind == "early":
                o = rand(int(rs.integers(1, 65 if i % 2 else L + 1)))
                a = rand(int(rs.integers(1, 65 if i % 2 else 33)))
            else:
                n, m = edges[i] if i < len(edges) else \
                    (int(x) for x in rs.choice([0, 1, L - 1, L], 2))
                o = rand(m)
                a = np.concatenate([o, rand(n)])[:n]
            lanes.append((a[:L], o[:L]))
    if tail:
        lanes += query_warp(tail)
    B = len(lanes)
    q = np.full((B, L), 6, np.uint8)
    t = np.full((B, L), 6, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b, (a, o) in enumerate(lanes):
        q[b, :a.size], t[b, :o.size] = a, o
        if b % 4 == 1:
            q[b, a.size:] = rs.integers(0, 4, size=L - a.size)
            t[b, o.size:] = rs.integers(0, 4, size=L - o.size)
        ql[b], tl[b] = a.size, o.size
    return q, t, ql, tl


def affine_pairs(np, B, L, seed=2, offsets=(128, 256)):
    """K3/K4 pairs of 1000-1900 codes: mutated copies (0-10%), clipped
    ends, and overlaps at offsets +-offsets[0] and +-offsets[1] (128 and
    256: on the edge of the 256 and 512 bands, whose walks then overflow;
    512 and 1024 for the 1024 and 2048 bands)."""
    rs = np.random.default_rng(seed)
    alpha = np.array([0, 1, 2, 3], np.uint8)
    q = np.full((B, L), 6, np.uint8)
    t = np.full((B, L), 6, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rs.integers(1000, 1900))
        core = rs.choice(alpha, size=n)
        kind = b % 8
        if kind in (0, 1, 4, 5):
            off = offsets[0] if kind < 2 else offsets[1]
            off -= kind % 2                   # +128 / -127, +256 / -255
            pre = rs.choice(alpha, size=off)
            if kind % 2 == 0:
                a, o = core, np.concatenate([pre, core[:n - off]])
            else:
                a, o = np.concatenate([pre, core[:n - off]]), core
        elif kind == 2:
            a = core
            o = _mutate(rs, np, core[int(rs.integers(0, 60)):
                                     n - int(rs.integers(0, 60))],
                        0.02, alpha)
        else:
            a = core
            o = _mutate(rs, np, core, rs.uniform(0, 0.1), alpha)
        o = o[:L]
        q[b, :a.size] = a
        t[b, :o.size] = o
        ql[b] = a.size
        tl[b] = o.size
    return q, t, ql, tl


# MAM correction's rounds: a targeted one (one partition an isoform of
# targeted_ccs, 26 of 77 rows at 1,300 bases, 1% noise) and a long one
# (mtdna_hifi's four molecules, 4 of 125 rows at 16,569 and 11,592 bases,
# 0.2% noise): (center lengths, rows a partition, noise)
CONSENSUS_SHAPES = {"targeted": ((1300,) * 26, 77, 0.01),
                    "long": ((16569, 16569, 11592, 11592), 125, 0.002)}


def star_partition(np, rs, L, K, noise, degrees=(1,), hotspots=0):
    """A seeded star partition: (center, {s: (ed, m_aln, s_aln, degree)})
    with the center itself as (0, m, m, degree).  The center is L random
    bases; each of the other K - 1 rows is the center with edits at rate
    ``noise`` (0.4 substitution, 0.3 insertion, 0.3 deletion), given as its
    alignment to the center (an insertion before its base).  ``hotspots``
    slots take 1-3 random inserted bases in each member with probability
    1/2, so their insertions differ and the MAM widens there.  Degrees are
    drawn from ``degrees``; a member equal to an earlier one is dropped."""
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    dash = np.uint8(ord("-"))
    codes = rs.integers(0, 4, L)
    center = letters[codes]
    m = center.tobytes().decode()
    part = {m: (0, m, m, int(rs.choice(degrees)))}
    spots = rs.choice(L, size=min(hotspots, L), replace=False)
    for _ in range(K - 1):
        kind = rs.choice(4, size=L, p=[1 - noise, 0.4 * noise, 0.3 * noise,
                                       0.3 * noise])
        ins = (kind == 2).astype(np.int64)
        ins[spots] += rs.integers(1, 4, spots.size) * (
            rs.random(spots.size) < 0.5)
        idx = np.repeat(np.arange(L), 1 + ins)
        last = np.r_[idx[1:] != idx[:-1], True]    # the base's own column
        sub = letters[(codes + rs.integers(1, 4, L)) % 4]
        base = np.where(kind == 1, sub, np.where(kind == 3, dash, center))
        m_aln = np.where(last, center[idx], dash)
        s_aln = np.where(last, base[idx],
                         letters[rs.integers(0, 4, idx.size)])
        s = s_aln[s_aln != dash].tobytes().decode()
        if not s or s in part:
            continue
        ed = int((kind == 1).sum() + (kind == 3).sum() + ins.sum())
        part[s] = (ed, m_aln.tobytes().decode(), s_aln.tobytes().decode(),
                   int(rs.choice(degrees)))
    return m, part


def consensus_round_inputs(np, shape, seed=6):
    """``CONSENSUS_SHAPES[shape]`` as ``correct/dense.py::pack_round``
    packs it: (mat, part, deg, rows).  One member in ten has degree 2 (a
    converged one); a slot in 500 is an insertion hotspot."""
    from isocon_tpu_torch.correct.dense import build_dense_mam, pack_round

    lengths, K, noise = CONSENSUS_SHAPES[shape]
    rs = np.random.default_rng(seed)
    parts = []
    for L in lengths:
        m, part = star_partition(np, rs, L, K, noise,
                                 degrees=(1,) * 9 + (2,),
                                 hotspots=L // 500)
        parts.append(build_dense_mam(m, part))
    return pack_round(parts)


def _edge_lengths(ql, tl, L):
    """Lengths 0 and 1 on either side, written over the first pairs."""
    for b, (n, m) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1), (0, 40),
                                (40, 0), (1, 90), (L - 1, 1)]):
        ql[b], tl[b] = n, m


def wavefront_long_pairs(np, B, L=32768, seed=4):
    """K5 pairs (query, target) of 16.5-20 kb in [B, L] planes: noisy copies
    at 0.4% (certify at band 128) and at 1.5% (clamped), copies without a
    1,600-base exon on either side (the length difference leaves the band),
    exact infixes, queries of 1-40 codes that match nothing (code 4: the
    empty span wins) and lengths 0 and 1."""
    rs = np.random.default_rng(seed)
    alpha = np.array([0, 1, 2, 3, 5], np.uint8)
    q = np.full((B, L), 6, np.uint8)
    t = np.full((B, L), 6, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rs.integers(16500, 20001))
        tgt = rs.choice(alpha, size=m, p=[.2499, .2499, .2499, .2499, .0004])
        kind = b % 6
        if kind in (0, 1):
            a = _mutate(rs, np, tgt, 0.004, alpha)
        elif kind == 2:
            a = _mutate(rs, np, tgt, 0.015, alpha)
        elif kind == 3:
            cut = int(rs.integers(2000, 12000))
            a = _mutate(rs, np, np.concatenate(
                [tgt[:cut], tgt[cut + 1600 + b % 2:]]), 0.003, alpha)
            if b % 4 == 3:
                a, tgt = tgt, a
        elif kind == 4:
            lo = int(rs.integers(0, 60))
            a = tgt[lo:m - int(rs.integers(0, 60)) - (b % 12 == 4) * 3000]
        else:
            a = np.full(int(rs.integers(1, 41)), 4, np.uint8)
        q[b, :a.size] = a
        t[b, :tgt.size] = tgt
        ql[b], tl[b] = a.size, tgt.size
    _edge_lengths(ql, tl, L)
    return q, t, ql, tl


def wavefront_wide_pairs(np, B, L=2048):
    """K5 pairs for the wider bands: the K1 and the K2 sets, half each,
    lengths 0 and 1, and queries of 2-9 codes that match nothing."""
    a = myers_pairs(np, B // 2, L, seed=5)
    h = hw_pairs(np, B - B // 2, L, seed=6)
    q, t, ql, tl = (np.concatenate([x, y]) for x, y in zip(a, h))
    _edge_lengths(ql, tl, L)
    for b in range(8, 16):
        q[b, :b - 6] = 4
        ql[b] = b - 6
    return q, t, ql, tl


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def check_equal(name, got, want):
    """Exact comparison; returns the max absolute difference (0)."""
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError("%s: shape %s vs plain %s"
                                 % (name, tuple(g.shape), tuple(w.shape)))
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    if err:
        raise AssertionError("%s differs from its plain version (max abs "
                             "err %d)" % (name, err))
    return err


def phase_build(_build, native):
    secs = _build.build_all()
    log("kernels built in %.1f s (nvcc, one process per source)" % secs)
    t0 = time.perf_counter()
    native.get_lib()
    log("host traceback library built in %.1f s (g++)"
        % (time.perf_counter() - t0))
    for entry in _build.BUILD_LOG:
        for line in entry.splitlines():
            if (line.startswith("==") or "Compiling entry" in line
                    or "Used" in line or "spill" in line):
                print("  " + line.strip())
    for kernel, regs, spill in register_kernel_report(_build.BUILD_LOG):
        log("register kernel %s: %d registers, %s" % (kernel, regs, spill))
    for name in _build.SOURCES:
        _build.load(name)
    return secs


def register_kernel_report(build_log):
    """(kernel, band and mode, registers, spill line) of each instantiation
    of the register kernels in ptxas' report: K3's (one per band and warps
    a pair) and K5's (one per band and mode), of K4's walk kernel (one per
    tile size) and of K1's and K2's band kernel (one per window)."""
    import re

    out = []
    for entry in build_log:
        if not entry.startswith(("== affine_sg", "== wavefront_ed",
                                 "== myers_ed")):
            continue
        kernel = spill = None
        for line in entry.splitlines():
            if "Compiling entry" in line:
                k3 = re.search(r"affine_warp_kernelILi(\d+)ELi(\d+)E", line)
                k5 = re.search(r"wavefront_warp_kernelILi(\d+)ELb([01])E",
                               line)
                k4 = re.search(r"affine_walk_kernelILi(\d+)E", line)
                k1 = re.search(r"myers_band_kernelILi(\d+)ELi\d+ELb([01])E",
                               line)
                kernel = None
                if k3:
                    kernel = "K3 Wp %d, warps a pair: %s" % (
                        64 * int(k3.group(1)) * int(k3.group(2)), k3.group(2))
                elif k4:
                    kernel = "K4 rows %s a tile" % k4.group(1)
                elif k5:
                    kernel = "K5 Wp %d %s" % (64 * int(k5.group(1)), "HW" if
                                              k5.group(2) == "1" else "NW")
                elif k1:
                    kernel = "K%s win %s" % ("2" if k1.group(2) == "1" else
                                             "1", k1.group(1))
            elif kernel and "spill" in line:
                spill = line.strip()
            elif kernel and "Used" in line:
                regs = int(re.search(r"Used (\d+) registers", line).group(1))
                out.append((kernel, regs, spill))
                kernel = None
    return sorted(out, key=lambda r: (r[0].split()[0],
                                      int(r[0].split()[2].rstrip(",")),
                                      r[0]))


def phase_check_myers(torch, np, myers, dev, L=2048, B=4096):
    q, t, ql, tl = myers_pairs(np, B, L)
    pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
    plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
    peq = myers.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    ib = ia + B
    qrow, trow, n, m = myers._swap(plen, ia.long(), ib.long())
    err = 0
    for win in (7, 9, 17, 33, None):
        Lk = L if win is None else max(L, 32 * win)
        w = Lk // 32 if win is None else win
        got = myers.myers_ed_pool(pool, plen, peq, ia, ib, L=Lk, win=win)
        torch.cuda.synchronize()
        want = myers.myers_ed_plain(peq[qrow], pool[trow], n, m, L=Lk, win=w)
        err = max(err, check_equal("K1 win=%s" % win, [got], [want]))
        ed = want.cpu().numpy()
        cert = (np.ones(B, bool) if win is None else
                myers.myers_certifies(ed, ql, tl, win=win))
        log("K1 win=%-4s L=%d B=%d: equal on every entry; %d of %d "
            "uncertified" % (win, Lk, B, int((~cert).sum()), B))
        if win == 7 and cert.all():
            raise AssertionError("K1 check set has no uncertified pair")
    return err


def phase_check_myers_hw(torch, np, myers, oracle, dev, L=2048, B=4096):
    q, t, ql, tl = hw_pairs(np, B, L)
    pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
    plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
    peq = myers.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    ib = ia + B
    n, m = plen[ia.long()], plen[ib.long()]
    decode = lambda row, k: "".join("ACGTXN"[c] for c in row[:k])
    truth = {}      # the oracle's (ed, ej) of the sampled pairs
    err = 0
    for win in (7, 9, 17, 33, None):
        Lk = L if win is None else max(L, 32 * win)
        w = Lk // 32 if win is None else win
        got = myers.myers_hw_pool(pool, plen, peq, ia, ib, L=Lk, win=win)
        torch.cuda.synchronize()
        want = myers.myers_hw_plain(peq[ia.long()], pool[ib.long()], n, m,
                                    L=Lk, win=w, full=win is None)
        err = max(err, check_equal("K2 win=%s" % win, got, want))
        ed, ej = (x.cpu().numpy() for x in want)
        cert = (np.ones(B, bool) if win is None else
                myers.myers_certifies_hw(ed, ql, tl, win=win))
        sample = np.flatnonzero(cert)[::max(1, int(cert.sum()) // 24)][:24]
        for i in sample.tolist():
            if i not in truth:
                d, _s0, e0, _ops = oracle.edit_distance_hw(
                    decode(q[i], ql[i]), decode(t[i], tl[i]))
                truth[i] = (d, e0 + 1)
            if (int(ed[i]), int(ej[i])) != truth[i]:
                raise AssertionError(
                    "K2 win=%s pair %d: certified (%d, %d) != oracle %s"
                    % (win, i, ed[i], ej[i], truth[i]))
        log("K2 win=%-4s L=%d B=%d: (ed, ej) equal on every entry; %d of %d "
            "uncertified; %d certified entries equal the oracle"
            % (win, Lk, B, int((~cert).sum()), B, len(sample)))
        if win == 7 and (cert.all() or not (ql > tl).any()
                         or not (ej == 0).any()):
            raise AssertionError("K2 check set lacks an uncertified pair, a "
                                 "query longer than its target or an empty "
                                 "span")
    return err


def phase_check_affine(torch, np, affine, acu, dev, L=2048, B=512):
    """K3 against ``sg_forward_plain`` and K4 against ``sg_walk_plain``
    and its epilogue against ``sg_rows_plain`` (the aligned rows up to
    each row's length, their lengths and counts) on every entry: K3's
    register kernel at every band it takes (256, 512, 1024) and its block
    kernel at 2048, each on pairs of which some overflow the band; the
    register kernel on all B pairs (one warp a pair) and on the first
    2 x SMS and 100 (four warps a pair), held to the plain versions of the
    same pairs."""
    k = torch.arange(B, device=dev)
    ma = torch.full((B,), 2, dtype=torch.int32, device=dev)
    mi = torch.tensor([-1, -2, -4], dtype=torch.int32, device=dev)[k % 3]
    go = torch.full((B,), 2, dtype=torch.int32, device=dev)
    ge = (k % 2).to(torch.int32)
    err3 = err4 = 0
    for Wp in (256, 512, 1024, 2048):
        q, t, ql, tl = affine_pairs(np, B, L, offsets=(
            (128, 256) if Wp <= 512 else (512, 1024)))
        pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
        plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
        ia = torch.arange(B, dtype=torch.int64, device=dev)
        ib = ia + B
        n, m = plen[ia], plen[ib]
        nops = int((n + m).max()) + 1
        pb, pei, pej, pdirs = affine.sg_forward_plain(
            pool[ia], pool[ib], n, m, ma, mi, go, ge, Wp)
        want = [pb, pei, pej] + plain_walk_rows(
            affine, pdirs, pei, pej, Wp, nops, (pool, ia, ib, n, m))
        del pdirs
        for Bk in ((B, 2 * SMS, 100) if Wp <= 1024 else (B,)):
            s = slice(0, Bk)
            best, ei, ej, dirs = acu.affine_fwd(pool, ia[s], ib[s], n[s],
                                                m[s], ma[s], mi[s], go[s],
                                                ge[s], Wp=Wp)
            seqs = (pool, ia[s], ib[s], n[s], m[s])
            walk = rows_to_length(torch, acu.affine_walk(
                dirs, ei, ej, Wp=Wp, nops=nops, seqs=seqs))
            torch.cuda.synchronize()
            name = "Wp=%d B=%d" % (Wp, Bk)
            err3 = max(err3, check_equal("K3 " + name, [best, ei, ej],
                                         [x[s] for x in want[:3]]))
            # the fused result against the plain forward + walk + rows ...
            check_equal("K3+K4 " + name, walk, [x[s] for x in want[3:]])
            if Bk == B:     # ... and K4 on the kernel's own bytes
                err4 = max(err4, check_equal(
                    "K4 " + name, walk, plain_walk_rows(
                        affine, dirs, ei, ej, Wp, nops, seqs)))
            n_ov = int(walk[3].sum())
            log("K3+K4 %s L=%d: equal on every entry, the rows up to their "
                "length; %d overflow" % (name, L, n_ov))
            if n_ov == 0:
                raise AssertionError("K3+K4 check set has no overflow at "
                                     + name)
            del dirs
    return err3, err4


def phase_check_wavefront(torch, np, wavefront, oracle, dev):
    """K5 against ``banded_ed_plain`` on every entry of (ed, end_j), NW and
    HW: the register kernel at every band it takes (128 and 256 at
    L = 32,768, 256, 512 and 1024 at L = 2048) and the wide kernel at 2048
    (L = 2048)."""
    decode = lambda row, k: "".join("ACGTXN"[c] for c in row[:k])
    err = 0
    for Wp, L, B in ((128, 32768, 96), (256, 32768, 24), (256, 2048, 512),
                     (512, 2048, 512), (1024, 2048, 512), (2048, 2048, 256)):
        small = Wp <= wavefront.SMALL_WP
        q, t, ql, tl = (wavefront_long_pairs(np, B, L) if L > 2048
                        else wavefront_wide_pairs(np, B, L))
        pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
        plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
        ia = torch.arange(B, dtype=torch.int32, device=dev)
        ib = ia + B
        delta = tl.astype(np.int64) - ql
        o_lo = -(Wp // 2 - 1)
        for hw_mode in (False, True):
            mode = "HW" if hw_mode else "NW"
            t0 = time.perf_counter()
            got = wavefront.banded_ed_pool(pool, plen, ia, ib, Wp=Wp,
                                           hw_mode=hw_mode)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = wavefront.banded_ed_plain(
                pool[:B], pool[B:], plen[:B], plen[B:], Wp=Wp,
                hw_mode=hw_mode, small=small)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            err = max(err, check_equal("K5 %s Wp=%d" % (mode, Wp), got, want))
            ed, ej = (x.cpu().numpy() for x in want)
            cert = wavefront.band_certifies(ed, ql, tl, Wp, hw_mode=hw_mode,
                                            small=small)
            has = {
                "an uncertified pair": (~cert).any(),
                "a certified pair": cert.any(),
                "lengths 0 and 1": all(
                    ((ql == n) & (tl == m)).any() for n, m in
                    ((0, 0), (0, 1), (1, 0), (1, 1))),
            }
            if Wp == 128:
                has["a clamped result"] = (ed[ql + tl > 1] == 120).any()
            if hw_mode:
                has["a query longer than its target"] = (ql > tl + 1).any()
                has["an empty span"] = ((ej == 0) & (ql > 1)).any()
            else:
                has["a length difference above the band"] = (
                    delta > o_lo + Wp - 1).any()
                has["a length difference below the band"] = (
                    delta < o_lo).any()
            missing = [k for k, v in has.items() if not v]
            if missing:
                raise AssertionError("K5 %s Wp=%d check set lacks %s"
                                     % (mode, Wp, ", ".join(missing)))
            n_oracle = 0
            if L <= 2048:       # the oracle holds the whole n x m matrix
                for i in np.flatnonzero(cert & (ql > 0) & (tl > 0))[
                        ::max(1, int(cert.sum()) // 16)][:16].tolist():
                    a, b = decode(q[i], ql[i]), decode(t[i], tl[i])
                    if hw_mode:
                        d, _s0, e0, _ops = oracle.edit_distance_hw(a, b)
                        truth = (d, e0 + 1)
                    else:
                        truth = (oracle.edit_distance(a, b), int(tl[i]))
                    if (int(ed[i]), int(ej[i])) != truth:
                        raise AssertionError(
                            "K5 %s Wp=%d pair %d: certified (%d, %d) != "
                            "oracle %s" % (mode, Wp, i, ed[i], ej[i], truth))
                    n_oracle += 1
            log("K5 %s Wp=%-4d L=%d B=%d: (ed, end_j) equal on every entry; "
                "%d uncertified, %d at the ceiling, %d with the length "
                "difference outside the band; %d certified entries equal "
                "the oracle; kernel %.2f s, plain %.1f s"
                % (mode, Wp, L, B, int((~cert).sum()),
                   int((ed >= (120 if small else 16000)).sum()),
                   int(((delta > o_lo + Wp - 1) | (delta < o_lo)).sum()),
                   n_oracle, t1 - t0, t2 - t1))
    return err


def sketch_inputs(torch, np, N, dev, seed=0, D=512):
    """K6's seeded input: square-rooted Poisson(3) k-mer counts, float32
    [N, D], every fifth row a copy of an earlier one (exact ties) and row 3
    all zero, and lengths of 700-1,899."""
    rs = np.random.default_rng(seed)
    prof = rs.poisson(3, size=(N, D)).astype(np.float32)
    for r in range(5, N, 5):
        prof[r] = prof[r // 2]
    prof[3] = 0
    lens = rs.integers(700, 1900, N).astype(np.int32)
    return (torch.sqrt(torch.from_numpy(prof)).to(dev),
            torch.from_numpy(lens).to(dev))


def nontargeted_profiles(torch, np, dev, work):
    """The first round's sketch input of the nontargeted run: the sorted
    unique reads of ``write_reads(path, N_READS, families=4)``, their
    square-rooted k-mer profiles and lengths, as ``approximate_matches``
    makes them."""
    from isocon_tpu_torch.graph.sketch import kmer_profile
    from isocon_tpu_torch.io import read_fasta
    from isocon_tpu_torch.workload import write_reads

    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "nontargeted_reads.fa")
    write_reads(path, N_READS, families=NONTARGETED_FAMILIES)
    seqs = sorted({s for _a, s in read_fasta(path)})
    os.unlink(path)
    prof = torch.from_numpy(np.stack([kmer_profile(s) for s in seqs]))
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    return torch.sqrt(prof).to(dev), lens.to(dev)


def sketch_plain_chunks(torch, sk, p, lens):
    """``sketch_scores_plain`` of all N rows, ``ROW_CHUNK`` rows a call."""
    N = p.shape[0]
    return torch.cat([sk.sketch_scores_plain(p, lens, r0,
                                             min(sk.ROW_CHUNK, N - r0))
                      for r0 in range(0, N, sk.ROW_CHUNK)])


def check_sketch(torch, sk, name, got, want, k=20):
    """K6's scores against the plain version's, bit for bit on every entry,
    and the top-k lists of both; returns the max abs error (0.0)."""
    if got.shape != want.shape:
        raise AssertionError("%s: shape %s vs plain %s"
                             % (name, tuple(got.shape), tuple(want.shape)))
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    err = float((got - want).abs().max())
    if differ or err:
        raise AssertionError("K6 %s: %d entries differ from the plain "
                             "version (max abs err %g)" % (name, differ, err))
    gv, gi = sk.topn(got, k)
    wv, wi = sk.topn(want, k)
    if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
        raise AssertionError("K6 %s: top-%d lists differ" % (name, k))
    return err


def check_topn(torch, sk, name, p, lens, want, k=20):
    """K6's fused top-n on the card against the plain version, every row:
    the first pass (``sketch_topn``, at the plan's segment count) against
    ``segment_topn_plain`` of the plain scores ``want``, the merge of its
    lists against ``merge_topn_plain`` of the same lists, and the function
    (``topn_scores``, one launch of each) against ``topn`` of ``want``,
    values bit for bit and indices.  Returns the max abs error of the first
    pass and of the merge (0.0 each) and the segment count."""
    N = p.shape[0]
    nseg = sk.plan_segments(
        N, torch.cuda.get_device_properties(p.device).multi_processor_count)
    pv, pi = sk.sketch_topn(p, lens, k, nseg)
    wv, wi = sk.segment_topn_plain(want, k, sk.segment_bounds(N, nseg))
    mv, mi = sk.merge_topn(pv, pi, k)
    mwv, mwi = sk.merge_topn_plain(pv, pi, k)
    fv, fi = sk.topn_scores(p, lens, k)
    tv, ti = sk.topn(want, k)
    errs = []
    for what, (gv, gi), (ev, ei) in (
            ("first pass", (pv, pi), (wv, wi)),
            ("merge", (mv, mi), (mwv, mwi)),
            ("fused function", (fv, fi), (tv, ti))):
        rows = int(((gv.view(torch.int32) != ev.view(torch.int32))
                    | (gi.to(torch.int64) != ei.to(torch.int64)))
                   .reshape(N, -1).any(dim=1).sum())
        if rows:
            raise AssertionError("K6 %s: the %s differs from its plain "
                                 "version in %d of %d rows"
                                 % (name, what, rows, N))
        errs.append(float((gv - ev).abs().nan_to_num().max()))
    return errs[0], errs[1], nseg


def phase_check_sketch(torch, np, sk, dev, real):
    """K6 against its plain versions on the card: the scores entry on every
    entry of the [N, N] matrix, launched in chunks of ``ROW_CHUNK`` rows,
    the plain version in the same chunks, and the top-20 lists of both;
    the fused top-n, its first pass and its merge on every row
    (``check_topn``): at N = 2,000, at N = 10,001 (ragged tiles and a
    ragged last chunk) on ``sketch_inputs`` and on ``real``, the first
    round's profiles of the nontargeted run.  Returns the max abs error of
    each entry and the plain scores of ``real``."""
    errs = dict.fromkeys(("sketch_scores", "sketch_topn", "sketch_merge"),
                         0.0)
    want = None
    for name, (p, lens) in (("N=2000", sketch_inputs(torch, np, 2000, dev)),
                            ("N=10001", sketch_inputs(torch, np, 10001, dev,
                                                      seed=1)),
                            ("nontargeted round 1", real)):
        N = p.shape[0]
        t0 = time.perf_counter()
        got = torch.cat([sk.sketch_scores(p, lens, r0,
                                          min(sk.ROW_CHUNK, N - r0))
                         for r0 in range(0, N, sk.ROW_CHUNK)])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = sketch_plain_chunks(torch, sk, p, lens)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        errs["sketch_scores"] = max(errs["sketch_scores"], check_sketch(
            torch, sk, name, got, want))
        del got
        e_top, e_merge, nseg = check_topn(torch, sk, name, p, lens, want)
        errs["sketch_topn"] = max(errs["sketch_topn"], e_top)
        errs["sketch_merge"] = max(errs["sketch_merge"], e_merge)
        vals = sk.topn(want, 20)[0]
        log("K6 %s (%d x %d): the scores entry equals the plain version on "
            "every entry, top-20 lists equal (%d rows hold a tie); the fused "
            "top-20 (%d segments), its first pass and its merge equal theirs "
            "on every row; scores entry %.2f s, plain %.1f s"
            % (name, N, N, int((vals[:, 1:] == vals[:, :-1])
                               .any(dim=1).sum()), nseg, t1 - t0, t2 - t1))
    torch.cuda.empty_cache()
    return errs, want


def check_consensus(torch, name, got, want):
    """The chain's outputs against the plain version's, exact: the columns'
    counts, majorities and flags, the partitions' error counts, the rows'
    lengths and mismatches, and each row's bytes up to its length."""
    err = check_equal(name, [g.cpu() for g in got[:4] + got[5:]],
                      list(want[:4] + want[5:]))
    lens = want[5].long()
    inside = torch.arange(want[4].shape[1])[None, :] < lens[:, None]
    return max(err, check_equal(name + " rows", [got[4].cpu()[inside]],
                                [want[4][inside]]))


def time_consensus(torch, np, cons, dev, packed, reps=5):
    """The consensus chain (both launches) on ``packed`` (a round as
    ``pack_round`` gives it) on the card, mean ms of ``reps`` chains after
    a warm-up (CUDA events), and its plain version on the CPU once; the
    chain held to the plain version.  Returns (ms, plain ms, the bytes a
    chain must read: the MAMs once, max abs err)."""
    flat, table, deg, rows = (torch.from_numpy(a) for a in packed)
    kw = dict(cols=int(table[:, 2].sum()), width=int(table[:, 2].max()))
    args = [a.to(dev) for a in (flat, table, deg, rows)]
    cons.consensus_cuda(*args, **kw)
    ms, got = _time(torch, lambda: cons.consensus_cuda(*args, **kw), reps)
    t0 = time.perf_counter()
    want = cons.consensus_plain(flat, table, deg, rows, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    shape = "P %d, rows %d (%d to correct), W %d-%d, %d mismatches" % (
        table.shape[0], deg.numel(), rows.shape[1], int(table[:, 2].min()),
        kw["width"], int(want[6].sum()))
    err = check_consensus(torch, "consensus " + shape, got, want)
    return ms, plain_ms, int(flat.numel()), err, shape


def phase_check_consensus(torch, np, cons, dev, clock_mhz):
    """The consensus chain against its plain version at a targeted round's
    shape and a long round's (``CONSENSUS_SHAPES``), timed; returns the
    targeted round's reading for the kernels line, and the max abs err."""
    reading, err = None, 0
    for name in ("targeted", "long"):
        ms, plain_ms, nbytes, e, shape = time_consensus(
            torch, np, cons, dev, consensus_round_inputs(np, name))
        err = max(err, e)
        bms, by = bound_ms(nbytes, 0, clock_mhz)
        log("consensus chain, %s round (%s): equal to the plain version on "
            "every output; chain %.3f ms, plain (CPU) %.1f ms, bound %.4f ms "
            "(%s), %.1fx the bound" % (name, shape, ms, plain_ms, bms, by,
                                        ms / bms))
        if reading is None:
            reading = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, shape=shape)
    torch.cuda.empty_cache()
    return reading, err


# ---------------------------------------------------------------------------
# the engine's routes: the host route on the CPU against the card's
# kernels, and the small rounds
# ---------------------------------------------------------------------------
ENGINE_ROUTES_SECONDS = 30     # the phase's budget
UNCAPPED = 2 ** 31 - 1


def check_card_engine(engine, label):
    """A card engine never takes the host route."""
    if engine.native_cpu:
        raise AssertionError("%s: a card engine has native_cpu set" % label)


def _ed_full_window(torch, myers, pool, plen, peq, ia, ib, L):
    """K1 at the full window (exact) on pool rows, to the host."""
    return myers.myers_ed_pool(pool, plen, peq, ia, ib, L=L,
                               win=None).to(torch.int64).cpu().numpy()


def _capped(np, d, k):
    return np.where((k < 0) | (d <= k), d, -1)


def routes_nw(torch, np, myers, native, dev, long_pairs, L=2048, B=4096):
    """(a): ``myers_ed_batch_k`` against K1 at the full window on the
    4,096 ``myers_pairs`` (no cap, 0, each pair's distance - 1, seeded
    random caps), then against the card engine's K5 route on 64 long
    pairs (cap 2,000, as ``phase_sharded``)."""
    q, t, ql, tl = myers_pairs(np, B, L)
    pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
    plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
    peq = myers.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    ed = _ed_full_window(torch, myers, pool, plen, peq, ia, ia + B, L)
    rs = np.random.default_rng(13)
    caps = {"none": np.full(B, -1), "0": np.zeros(B, np.int64),
            "ed-1": ed - 1, "random": rs.integers(-1, 800, B)}
    err = 0
    for name, k in caps.items():
        t0 = time.perf_counter()
        got = native.myers_ed_batch_k(q, ql, t, tl, k)
        secs = time.perf_counter() - t0
        err = max(err, _max_err(np, got, _capped(np, ed, k)))
        log("engine routes (a): myers_ed_batch_k, caps %s, %d pairs at L "
            "%d in %.3f s: %d of them -1; max abs err against K1 (full "
            "window) %d" % (name, B, L, secs, int((got < 0).sum()), err))
    from isocon_tpu_torch.ops.engine import PairEngine

    card = PairEngine(device="cuda")
    check_card_engine(card, "engine routes (a)")
    k = np.full(len(long_pairs), 2000)
    want, _ = card.edit_distances(long_pairs, k_cap=k)
    planes = _planes(np, long_pairs)
    t0 = time.perf_counter()
    got = native.myers_ed_batch_k(*planes, k)
    secs = time.perf_counter() - t0
    err = max(err, _max_err(np, got, want))
    if not card.counters["ed_pairs_wavefront"]:
        raise AssertionError("engine routes (a): K5 did not run")
    log("engine routes (a): myers_ed_batch_k on %d long pairs (cap 2,000) "
        "in %.3f s against the card engine's K5 route (rungs %s): max abs "
        "err %d" % (len(long_pairs), secs, json.dumps(
            {"%s %d" % r: v for r, v in card.wavefront_rungs.items()}), err))
    if err:
        raise AssertionError("engine routes (a): the host route differs "
                             "from the card's (max abs err %d)" % err)


def _planes(np, pairs):
    """(q, qlen, t, tlen) padded uint8 code planes of string pairs."""
    from isocon_tpu_torch.ops.encode import encode_seq

    L = max(1, max(max(len(a), len(b)) for a, b in pairs))
    q = np.zeros((len(pairs), L), np.uint8)
    t = np.zeros_like(q)
    for i, (a, b) in enumerate(pairs):
        q[i, :len(a)] = encode_seq(a).view(np.uint8)
        t[i, :len(b)] = encode_seq(b).view(np.uint8)
    return (q, np.array([len(a) for a, _ in pairs]), t,
            np.array([len(b) for _, b in pairs]))


def routes_hw(torch, np, myers, native, dev, L=2048, B=4096):
    """(b): ``hw_traceback_batch(band=64)`` with seeded caps against K2 at
    the full window on ``hw_pairs``: ed on every entry, ej wherever
    ed >= 0."""
    q, t, ql, tl = hw_pairs(np, B, L)
    pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
    plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
    peq = myers.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int32, device=dev)
    ed, ej = (x.cpu().numpy().astype(np.int64) for x in myers.myers_hw_pool(
        pool, plen, peq, ia, ia + B, L=L, win=None))
    caps = np.random.default_rng(14).integers(0, 256, B)
    caps[::7] = ed[::7]                    # on the distance itself
    caps[3::7] = np.maximum(ed[3::7] - 1, 0)
    t0 = time.perf_counter()
    res = native.hw_traceback_batch(_strings(np, q, t, ql, tl), band=64,
                                    k_cap=caps)
    secs = time.perf_counter() - t0
    got = np.array([r[0] for r in res], np.int64)
    gej = np.array([r[2] + 1 for r in res], np.int64)
    want = _capped(np, ed, caps)
    known = want >= 0
    err = max(_max_err(np, got, want), _max_err(np, gej[known], ej[known]))
    log("engine routes (b): hw_traceback_batch(band=64) on %d hw_pairs "
        "with caps in %.3f s: %d under their cap; max abs err against K2 "
        "(full window) %d" % (B, secs, int(known.sum()), err))
    if err or known.all() or not known.any():
        raise AssertionError("engine routes (b): the host route differs "
                             "from K2 (max abs err %d) or the caps cut "
                             "all or none" % err)


def real_pairs(np, work, n_reads=N_READS, per_query=8, step=20):
    """A few thousand NN-search pairs of the 10k workload: the reads
    sorted by length as ``graph/nn.py`` sorts them, every ``step``-th
    read against the next ``per_query``, capped as phase 1's first round
    caps them (min(63, length)).  Returns (reads, ia, ib, caps)."""
    from isocon_tpu_torch.io import read_fasta
    from isocon_tpu_torch.workload import write_reads

    path = os.path.join(work, "route_reads.fa")
    write_reads(path, n_reads)
    seqs = [s for _a, s in read_fasta(path)]
    os.unlink(path)
    order = sorted(range(len(seqs)), key=lambda i: (len(seqs[i]), seqs[i]))
    q = np.repeat(np.arange(0, len(order) - per_query, step), per_query)
    t = q + np.tile(np.arange(1, per_query + 1), q.size // per_query)
    o = np.asarray(order)
    lens = np.array([len(s) for s in seqs])
    caps = np.minimum(63, lens[o[q]])
    return seqs, o[q], o[t], caps


def routes_engines(torch, np, dev, reads, ia, ib, caps):
    """(c): a CPU engine (the host route) against a card engine on the
    real pairs, ``edit_distances_idx`` NW and HW with phase 1's caps:
    every entry and every counter the host route keeps must be equal."""
    from isocon_tpu_torch.ops.engine import PairEngine

    host = PairEngine(device="cpu")
    card = PairEngine(device="cuda")
    if not host.native_cpu:
        raise AssertionError("engine routes (c): the CPU engine is not on "
                             "the host route")
    check_card_engine(card, "engine routes (c)")
    err = 0
    secs = {}
    for hw_mode in (False, True):
        out = []
        for role, engine in (("host", host), ("card", card)):
            ids = engine.add_seqs(reads)
            t0 = time.perf_counter()
            out.append(engine.edit_distances_idx(ids[ia], ids[ib], k_cap=caps,
                                                 hw_mode=hw_mode))
            secs[(hw_mode, role)] = time.perf_counter() - t0
        (ed, ej), (wed, wej) = out
        known = wed >= 0
        err = max(err, _max_err(np, ed, wed), _max_err(np, ej[known],
                                                       wej[known]))
        log("engine routes (c): %s on %d real pairs (caps min(63, len)): "
            "host %.3f s, card %.3f s; %d under their cap; max abs err %d"
            % ("HW" if hw_mode else "NW", len(ia), secs[(hw_mode, "host")],
               secs[(hw_mode, "card")], int(known.sum()), err))
    # counters of the card route alone: its windows, and the bytes it
    # copies to and from the card, which the host route never copies
    route_only = ("ed_pairs_full_window", "ed_pairs_wavefront",
                  "fetch_bytes", "upload_bytes")
    for key, value in host.counters.items():
        if (not key.endswith("seconds") and key not in route_only
                and card.counters[key] != value):
            raise AssertionError("engine routes (c): counter %s: host %d, "
                                 "card %d" % (key, value, card.counters[key]))
    log("engine routes (c): counters equal (%s); the card's own: K1/K2 "
        "rungs %s, full window %d" % (
            json.dumps({k: v for k, v in host.counters.items() if not
                        k.endswith("seconds") and k not in route_only}),
            json.dumps({"%s %d" % r: v for r, v in card.myers_rungs.items()}),
            card.counters["ed_pairs_full_window"]))
    if err:
        raise AssertionError("engine routes (c): the host route differs "
                             "from the card's (max abs err %d)" % err)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def routes_small_rounds(torch, np, myers, wavefront, native, dev, reads,
                        ia, ib, caps, long_pairs, turns=7):
    """(d): the JAX engine's small-round route (ED rounds of <= 64 NW or
    <= 256 HW pairs to the host, ``isocon_tpu/ops/engine.py:749-769``)
    against the card's round trip, host and card in turns: 64 real NW
    pairs of the 10k workload, ``myers_ed_batch_k`` (no cap) against K1's
    launch and collect (window 7, L 2,048); 256 HW pairs,
    ``hw_traceback_batch(band=64)`` (phase 1's caps) against K2's; 64
    long pairs, ``myers_ed_batch_k`` (no cap) against K5's (band 128, L
    32,768).  Logs the medians of ``turns``: the route is not switched."""
    from isocon_tpu_torch.ops.engine import PairEngine

    engine = PairEngine(device="cuda")
    check_card_engine(engine, "engine routes (d)")
    sharder = engine.sharder

    def pooled(pairs, L):
        seqs = sorted({s for p in pairs for s in p})
        row = {s: r for r, s in enumerate(seqs)}
        q, ql, _t, _tl = _planes(np, [(s, s) for s in seqs])
        mat = np.full((len(seqs), L), 6, np.uint8)
        mat[:, :q.shape[1]] = q
        pool = torch.from_numpy(mat).to(dev)
        plen = torch.from_numpy(ql.astype(np.int32)).to(dev)
        pa = np.array([row[a] for a, _ in pairs], np.int32)
        pb = np.array([row[b] for _, b in pairs], np.int32)
        return pool, plen, pa, pb

    def run(name, host_fn, card_fn):
        host_fn(), card_fn()                     # warm both
        hs, cs = [], []
        for _ in range(turns):
            t0 = time.perf_counter()
            host_fn()
            hs.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card_fn()
            cs.append(1e3 * (time.perf_counter() - t0))
        log("engine routes (d) %s: host %.3f ms (min %.3f), card %.3f ms "
            "(min %.3f), medians of %d turns"
            % (name, _median(hs), min(hs), _median(cs), min(cs), turns))

    nw = [(reads[a], reads[b]) for a, b in zip(ia[:64], ib[:64])]
    planes = _planes(np, nw)
    pool, plen, pa, pb = pooled(nw, 2048)
    peq = myers.peq_table(pool, plen)
    run("NW 64 pairs, 10k reads, L 2048 (myers_ed_batch_k / K1 win 7)",
        lambda: native.myers_ed_batch_k(*planes, np.full(64, UNCAPPED)),
        lambda: sharder.collect(sharder.launch(
            myers.myers_ed_pool, (pool, plen, peq), (pa, pb), L=2048,
            win=7)))
    hw = [(reads[a], reads[b]) for a, b in zip(ia[:256], ib[:256])]
    pool, plen, pa, pb = pooled(hw, 2048)
    peq = myers.peq_table(pool, plen)
    run("HW 256 pairs, 10k reads, L 2048 (hw_traceback_batch / K2 win 7)",
        lambda: native.hw_traceback_batch(hw, band=64, k_cap=caps[:256]),
        lambda: sharder.collect(sharder.launch(
            myers.myers_hw_pool, (pool, plen, peq), (pa, pb), L=2048,
            win=7)))
    planes = _planes(np, long_pairs)
    pool, plen, pa, pb = pooled(long_pairs, 32768)
    run("NW 64 pairs, long reads, L 32768 (myers_ed_batch_k / K5 Wp 128)",
        lambda: native.myers_ed_batch_k(*planes, np.full(len(long_pairs),
                                                         UNCAPPED)),
        lambda: sharder.collect(sharder.launch(
            wavefront.banded_ed_pool, (pool, plen), (pa, pb), Wp=128)))


def phase_engine_routes(torch, np, myers, wavefront, native, dev):
    """The engine's host route (``native/myers_ed.cc``,
    ``native/hw_traceback.cc``) against the card's kernels, and the
    small-round readings: (a)-(d) above, within
    ``ENGINE_ROUTES_SECONDS``; each step raises on a difference.  Kernel
    launches made here do not count (each main path sets the counts to 0
    first)."""
    from isocon_tpu_torch.io import read_fasta
    from isocon_tpu_torch.ops._build import BUILD_DIR
    from isocon_tpu_torch.workload import write_long_reads

    secs = {}
    t0 = time.perf_counter()
    native.build("myers_ed")
    path = os.path.join(BUILD_DIR, "route_long.fa")
    write_long_reads(path, 72)
    long_reads = [s for _a, s in read_fasta(path)]
    os.unlink(path)
    # reads i and i + 8 are copies of one isoform
    long_pairs = [(long_reads[i], long_reads[i + 8]) for i in range(64)]
    secs["inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes_nw(torch, np, myers, native, dev, long_pairs)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes_hw(torch, np, myers, native, dev)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reads, ia, ib, caps = real_pairs(np, BUILD_DIR)
    routes_engines(torch, np, dev, reads, ia, ib, caps)
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes_small_rounds(torch, np, myers, wavefront, native, dev, reads, ia,
                        ib, caps, long_pairs)
    secs["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    total = sum(secs.values())
    log("engine routes phase: %s s, %.1f s in all (budget %d s)"
        % (", ".join("(%s) %.1f" % kv for kv in secs.items()), total,
           ENGINE_ROUTES_SECONDS))
    if total > ENGINE_ROUTES_SECONDS:
        raise AssertionError("engine routes phase took %.1f s, over its "
                             "%d s" % (total, ENGINE_ROUTES_SECONDS))


def _sha256(path):
    with open(path, "rb") as fh:
        data = fh.read()
    return hashlib.sha256(data).hexdigest(), data


VOLUME = ("ed_pairs", "ed_calls", "align_pairs", "align_calls")
# each unsharded main path's max_memory_allocated before its alignment
# chunks were all launched ahead of their collect (NVIDIA H100 80GB HBM3);
# a run may exceed it by PEAK_SLACK at most
PEAK_BYTES = {"10k": 3701106176, "long": 4961243136,
              "nontargeted": 4109443584}
PEAK_SLACK = 0.02
# the unsharded 10k run's candidates_converged.fa, kept in the build
# directory for ``time_static_graph``
CANDIDATES_10K = "candidates_converged_10k.fa"


def phase_main_path(torch, _build, dev, long_reads=False,
                    nontargeted=False, mesh=None):
    """``pipeline`` on the 10,000 reads, with ``long_reads`` on the 500
    long reads, or with ``nontargeted`` ``pipeline --nontargeted`` on the
    10,000 reads of four gene families; with ``mesh`` (a device list,
    ``params.device_mesh``) sharded over it.  Returns the launches of each
    kernel over the whole run (one a block when sharded)."""
    from isocon_tpu_torch import cli
    from isocon_tpu_torch.io import read_fasta
    from isocon_tpu_torch.workload import write_long_reads, write_reads

    with open(os.path.join(ROOT, "isocon_tpu_torch",
                           "smoke_expect.json")) as fh:
        expect = json.load(fh)
    if long_reads:
        expect = expect["long"]
        label = "long-read pipeline"
        needed = ("wavefront_ed", "affine_fwd", "affine_walk")
    elif nontargeted:
        expect = expect["nontargeted"]
        assert expect["n_reads"] == N_READS
        assert expect["families"] == NONTARGETED_FAMILIES
        label = "nontargeted pipeline"
        needed = ("kmer_profile", "sketch_topn", "sketch_merge", "myers_ed",
                  "affine_fwd", "affine_walk")
    else:
        assert expect["n_reads"] == N_READS
        label = "10k pipeline"
        needed = ("myers_ed", "myers_hw", "affine_fwd", "affine_walk")
    if mesh is not None:
        label += " on %d shards" % len(mesh)
    cell_10k = not (long_reads or nontargeted or mesh is not None)
    n_reads = expect["n_reads"]
    work = os.path.join(_build.BUILD_DIR, "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    reads = os.path.join(work, "reads.fa")
    if long_reads:
        isoforms = write_long_reads(reads, n_reads)
    else:
        isoforms = write_reads(reads, n_reads, families=(
            NONTARGETED_FAMILIES if nontargeted else 1))
    out = os.path.join(work, "out")
    argv = ["pipeline", "-fl_reads", reads, "-outfolder", out, "--device",
            "cuda"] + (["--nontargeted"] if nontargeted else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    run, params = cli.parse(argv)
    params.device_mesh = mesh
    _build.reset_launches()
    t0 = time.perf_counter()
    engine, phase1 = run(params)
    torch.cuda.synchronize()
    check_card_engine(engine, label)
    if mesh is not None and engine.sharder.devices != list(mesh):
        raise AssertionError("%s: the engine is not on the mesh" % label)
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    launches1 = phase1["launches"]
    launches2 = {k: launches[k] - launches1[k] for k in launches}
    c = engine.counters

    phase_secs = {}
    with open(os.path.join(out, "logfile.txt")) as fh:
        for line in fh:       # timestamped progress, and the phase timers
            text = line.split("\t")[-1]
            if text.startswith(("Starting", "Iteration", "TOTAL", "engine:",
                                "TIME ELAPSED", "stat_filter STEP")):
                print("  " + line.rstrip())
            if text.startswith("TIME ELAPSED FOR FINDING CANDIDATES"):
                phase_secs[1] = float(text.rsplit(":", 1)[1])
            if text.startswith("TIME ELAPSED FOR STATISTICAL TEST"):
                phase_secs[2] = float(text.rsplit(":", 1)[1])
    log("%s on %d reads (cuda): %.2f s in all; phase 1 %.2f s, phase "
        "2 %.2f s (logfile.txt)" % (label, n_reads, secs, phase_secs[1],
                                    phase_secs[2]))
    log("phase 1: %d ED pairs in %.2f s (%d calls), %d alignments in %.2f s "
        "(%d calls); launches %s"
        % (phase1["ed_pairs"], phase1["ed_seconds"], phase1["ed_calls"],
           phase1["align_pairs"], phase1["align_seconds"],
           phase1["align_calls"], json.dumps(launches1)))
    log("phase 2: %d ED pairs in %.2f s (%d calls), %d alignments in %.2f s "
        "(%d calls); %d survivors of the HW prefilter, %.2f s in "
        "hw_traceback_batch; launches %s"
        % (c["ed_pairs"] - phase1["ed_pairs"],
           c["ed_seconds"] - phase1["ed_seconds"],
           c["ed_calls"] - phase1["ed_calls"],
           c["align_pairs"] - phase1["align_pairs"],
           c["align_seconds"] - phase1["align_seconds"],
           c["align_calls"] - phase1["align_calls"], c["hw_survivors"],
           c["hw_traceback_seconds"], json.dumps(launches2)))
    peak = torch.cuda.max_memory_allocated(dev)
    log("whole run: ed_pairs_full_window %d, ed_pairs_wavefront %d (phase 1 "
        "%d), align_overflows %d, max_memory_allocated %d bytes"
        % (c["ed_pairs_full_window"], c["ed_pairs_wavefront"],
           phase1["ed_pairs_wavefront"], c["align_overflows"], peak))
    if mesh is None:
        cell = "long" if long_reads else (
            "nontargeted" if nontargeted else "10k")
        limit = PEAK_BYTES[cell] * (1 + PEAK_SLACK)
        log("%s: max_memory_allocated %d bytes, %.4f x the %d of the "
            "launch-then-collect loops' parent (limit %.2f x)"
            % (label, peak, peak / PEAK_BYTES[cell], PEAK_BYTES[cell],
               1 + PEAK_SLACK))
        if peak > limit:
            raise AssertionError("%s: max_memory_allocated %d bytes, over "
                                 "%d" % (label, peak, limit))
    if nontargeted:
        log("sketch: %d rows in %.2f s in phase 1 (%.2f s of profiles; K7 "
            "launches %d; K6 launches: %d first passes, %d merges, %d of "
            "the scores entry), %d rows in phase 2 (%d first passes)"
            % (phase1["sketch_rows"], phase1["sketch_seconds"],
               phase1["sketch_profile_seconds"], launches1["kmer_profile"],
               launches1["sketch_topn"], launches1["sketch_merge"],
               launches1["sketch_scores"],
               c["sketch_rows"] - phase1["sketch_rows"],
               launches2["sketch_topn"]))
        finals = {seq for _a, seq in read_fasta(
            os.path.join(out, "final_candidates.fa"))}
        log("information, not a gate: %d of the generator's %d isoforms are "
            "among the %d final candidates"
            % (sum(iso in finals for iso in isoforms), len(isoforms),
               len(finals)))
    if engine.myers_rungs:
        log("K1/K2 rungs (mode, window words, 0 = the full width: pairs): "
            + ", ".join("%s %d: %d" % (mode, win, k) for (mode, win), k in
                        sorted(engine.myers_rungs.items())))
    if engine.wavefront_rungs:
        log("K5 rungs (mode, band: pairs): " + ", ".join(
            "%s %d: %d" % (mode, Wp, k) for (mode, Wp), k in
            sorted(engine.wavefront_rungs.items())))

    for name in ("candidates_converged", "final_candidates", "cluster_info"):
        fname = name + (".tsv" if name == "cluster_info" else ".fa")
        digest, data = _sha256(os.path.join(out, fname))
        log("%s: %d %s, sha256 %s" % (
            fname, data.count(b">") or data.count(b"\n"),
            "rows" if fname.endswith(".tsv") else "candidates", digest))
        if digest != expect[name + "_sha256"]:
            raise AssertionError("%s: %s sha256 %s != the JAX package's %s"
                                 % (label, fname, digest,
                                    expect[name + "_sha256"]))
    # the same searches, edges and tests make the same engine calls
    for key in VOLUME:
        if phase1[key] != expect[key]:
            raise AssertionError("%s, phase 1: engine %s %d != the JAX "
                                 "package's %d" % (label, key, phase1[key],
                                                   expect[key]))
        if c[key] != expect["end_" + key]:
            raise AssertionError("%s, whole run: engine %s %d != the JAX "
                                 "package's %d" % (label, key, c[key],
                                                   expect["end_" + key]))
    if c["hw_survivors"] != expect["hw_survivors"]:
        raise AssertionError("%s: %d survivors of the HW prefilter != the "
                             "JAX package's %d" % (label, c["hw_survivors"],
                                                   expect["hw_survivors"]))
    log("engine volume equals the JAX package's: phase 1 %s, whole run %s, "
        "%d HW survivors"
        % (json.dumps({k: expect[k] for k in VOLUME}),
           json.dumps({k: expect["end_" + k] for k in VOLUME}),
           expect["hw_survivors"]))
    for name in needed:
        if launches[name] <= 0:
            raise AssertionError("%s: kernel %s was not launched"
                                 % (label, name))
    for name in ("consensus_vote", "consensus_correct"):    # MAM rounds
        if launches1[name] <= 0:
            raise AssertionError("%s: kernel %s was not launched in phase 1"
                                 % (label, name))
    if nontargeted and launches1["sketch_topn"] <= 0:
        raise AssertionError("%s: K6 was not launched in phase 1" % label)
    if nontargeted and (
            launches["kmer_profile"] != launches["sketch_topn"]
            or c["sketch_profile_card_rows"] != c["sketch_rows"]):
        raise AssertionError(
            "%s: K7 launched %d times for %d sketch calls, built %d of %d "
            "rows" % (label, launches["kmer_profile"],
                      launches["sketch_topn"], c["sketch_profile_card_rows"],
                      c["sketch_rows"]))
    both = needed if long_reads else ("myers_ed", "affine_fwd", "affine_walk")
    for name in both:
        if launches1[name] <= 0 or launches2[name] <= 0:
            raise AssertionError("%s: kernel %s was not launched in both "
                                 "phases" % (label, name))
    if long_reads and not (
            0 < phase1["ed_pairs_wavefront"] < c["ed_pairs_wavefront"]
            and any(mode == "HW" for mode, _wp in engine.wavefront_rungs)):
        raise AssertionError("long-read pipeline: the wavefront did not run "
                             "in both phases and both modes")
    if cell_10k:     # phase 1's candidates, for the static graph's K2 step
        shutil.copy(os.path.join(out, "candidates_converged.fa"),
                    os.path.join(_build.BUILD_DIR, CANDIDATES_10K))
    shutil.rmtree(work, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# the sharded runs (parallel/): logical shards of the one card
# ---------------------------------------------------------------------------
SHARDED_SECONDS = 120       # the five steps' budget, all together


def _strings(np, q, t, ql, tl):
    """Code planes as string pairs (code 4 as X, 5 as N)."""
    lut = np.frombuffer(b"ACGTXN", np.uint8)
    return [(lut[q[b, :ql[b]]].tobytes().decode(),
             lut[t[b, :tl[b]]].tobytes().decode()) for b in range(len(ql))]


def _max_err(np, got, want):
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    if got.shape != want.shape:
        raise AssertionError("shape %s vs %s" % (got.shape, want.shape))
    return int(np.abs(got - want).max()) if got.size else 0


def sharded_route_cases(np):
    """(a)'s inputs: the NW window ladder on K1's pairs (515, L 2048), HW
    on K2's (515), alignments on K3/K4's (265, scores varied), K5 NW
    (cap 2,000) and HW on 25 of the long pairs; no count a multiple of
    2 or 3."""
    ed_pairs = _strings(np, *myers_pairs(np, 515, 2048))
    hw_pairs_ = _strings(np, *hw_pairs(np, 515, 2048))
    align_pairs = _strings(np, *affine_pairs(np, 265, 2048))
    scores = [(2, (-1, -2, -4)[i % 3], 2, i % 2)
              for i in range(len(align_pairs))]
    # past the first 8, whose lengths _edge_lengths sets over pad codes
    long_pairs = _strings(np, *(x[8:] for x in wavefront_long_pairs(np, 33)))
    return ed_pairs, hw_pairs_, align_pairs, scores, long_pairs


def sharded_engine_routes(torch, np, _build, dev, cases):
    """(a): a local engine and engines on 2 and 3 shards of the card run
    the four routes; every entry, counter and rung must be equal, and each
    sharded engine must launch n times the local one's kernels (one launch
    a block).  Returns each kernel's max abs error."""
    from isocon_tpu_torch.ops.engine import PairEngine
    from isocon_tpu_torch.parallel import Sharder

    ed_pairs, hw_pairs_, align_pairs, scores, long_pairs = cases
    caps = [2000] * len(long_pairs)

    def run(engine):
        _build.reset_launches()
        out = {"myers_ed": engine.edit_distances(ed_pairs),
               "myers_hw": engine.edit_distances(hw_pairs_, hw_mode=True),
               "align": engine.align_pairs(align_pairs, scores),
               "wave_nw": engine.edit_distances(long_pairs, k_cap=caps),
               "wave_hw": engine.edit_distances(long_pairs, hw_mode=True)}
        torch.cuda.synchronize()
        return out, dict(_build.LAUNCHES)

    local = PairEngine(device="cuda")
    check_card_engine(local, "sharded (a)")
    want, want_launches = run(local)
    log("sharded (a): local engine's launches %s" % json.dumps(
        want_launches))
    errs = {}
    for n in (2, 3):
        engine = PairEngine(device="cuda", sharder=Sharder([dev] * n))
        check_card_engine(engine, "sharded (a)")
        got, launches = run(engine)
        errs["myers_ed"] = max(errs.get("myers_ed", 0), _max_err(
            np, got["myers_ed"][0], want["myers_ed"][0]))
        hw_known = want["myers_hw"][0] >= 0
        errs["myers_hw"] = max(errs.get("myers_hw", 0), _max_err(
            np, got["myers_hw"][0], want["myers_hw"][0]), _max_err(
            np, got["myers_hw"][1][hw_known], want["myers_hw"][1][hw_known]))
        wave = 0
        for key in ("wave_nw", "wave_hw"):
            known = want[key][0] >= 0
            wave = max(wave, _max_err(np, got[key][0], want[key][0]),
                       _max_err(np, got[key][1][known], want[key][1][known]))
        errs["wavefront_ed"] = max(errs.get("wavefront_ed", 0), wave)
        same_alignments = got["align"] == want["align"]
        errs["affine_fwd"] = errs["affine_walk"] = 0
        if any(errs.values()) or not same_alignments:
            raise AssertionError("sharded (a), %d shards: results differ "
                                 "from the local engine's (max abs err %s, "
                                 "alignments equal: %s)"
                                 % (n, json.dumps(errs), same_alignments))
        for key, value in local.counters.items():
            if not key.endswith("seconds") and engine.counters[key] != value:
                raise AssertionError("sharded (a), %d shards: counter %s %d "
                                     "!= local %d" % (n, key,
                                                      engine.counters[key],
                                                      value))
        if (engine.myers_rungs != local.myers_rungs
                or engine.wavefront_rungs != local.wavefront_rungs):
            raise AssertionError("sharded (a), %d shards: rungs differ" % n)
        for kname, k in want_launches.items():
            if launches[kname] != n * k:
                raise AssertionError("sharded (a), %d shards: %s launched "
                                     "%d times, not %d x %d"
                                     % (n, kname, launches[kname], n, k))
        log("sharded (a), %d shards of %s: every entry, counter and rung "
            "equal; launches %s" % (n, dev, json.dumps(launches)))
    for kname in ("myers_ed", "myers_hw", "affine_fwd", "affine_walk",
                  "wavefront_ed"):
        if want_launches[kname] <= 0:
            raise AssertionError("sharded (a): %s was not launched" % kname)
    return errs


def sharded_phase1(torch, _build, dev, mesh):
    """(c): ``get_candidates`` on the 10,000 reads on ``mesh``: the digest
    of ``candidates_converged.fa`` and the phase-1 engine volume must be
    the JAX package's."""
    from isocon_tpu_torch import cli
    from isocon_tpu_torch.workload import write_reads

    with open(os.path.join(ROOT, "isocon_tpu_torch",
                           "smoke_expect.json")) as fh:
        expect = json.load(fh)
    work = os.path.join(_build.BUILD_DIR, "smoke_sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    reads = os.path.join(work, "reads.fa")
    write_reads(reads, N_READS)
    out = os.path.join(work, "out")
    run, params = cli.parse(["get_candidates", "-fl_reads", reads,
                             "-outfolder", out, "--device", "cuda"])
    params.device_mesh = mesh
    _build.reset_launches()
    engine = run(params)
    torch.cuda.synchronize()
    check_card_engine(engine, "sharded (c)")
    digest, data = _sha256(os.path.join(out, "candidates_converged.fa"))
    log("sharded (c): get_candidates on %d reads, %d shards: %d "
        "candidates, sha256 %s; %s; launches %s"
        % (N_READS, engine.sharder.n, data.count(b">"), digest,
           engine.stats_line(), json.dumps(_build.LAUNCHES)))
    if digest != expect["candidates_converged_sha256"]:
        raise AssertionError("sharded (c): candidates_converged.fa sha256 "
                             "%s != the JAX package's" % digest)
    for key in VOLUME:
        if engine.counters[key] != expect[key]:
            raise AssertionError("sharded (c): engine %s %d != the JAX "
                                 "package's %d" % (key, engine.counters[key],
                                                   expect[key]))
    shutil.rmtree(work, ignore_errors=True)


def sharded_seam(_build, dev, cases):
    """(d): two processes on localhost over gloo, each with a mesh of the
    one card (``parallel/dryrun.py``), run (a)'s NW and alignment pairs;
    both must read the local engine's results."""
    from isocon_tpu_torch.ops.engine import PairEngine
    from isocon_tpu_torch.parallel import dryrun

    ed_pairs, _hw, align_pairs, scores, _long = cases
    local = PairEngine(device="cuda")
    check_card_engine(local, "sharded (d)")
    want = dryrun.engine_results(local, ed_pairs, align_pairs, scores)
    got = dryrun.run(ed_pairs, align_pairs, scores, procs=2, local=1,
                     device="cuda", timeout=150, workdir=_build.BUILD_DIR)
    for r in got:
        for key in ("ed", "alignments", "volume"):
            if r[key] != want[key]:
                raise AssertionError("sharded (d): process %d's %s differs "
                                     "from the local engine's"
                                     % (r["rank"], key))
        log("sharded (d): process %d of 2 on the mesh %s equals the local "
            "engine; its launches %s"
            % (r["rank"], ", ".join("%s@%d" % x for x in zip(
                r["mesh"], r["ranks"])), json.dumps(r["launches"])))


def sharded_cli(torch, _build):
    """(e): ``make_engine`` with ``--devices -1`` shards over every
    visible card; ``--devices 1`` builds no sharder."""
    from isocon_tpu_torch import cli

    reads = os.path.join(_build.BUILD_DIR, "cli_reads.fa")
    with open(reads, "w") as fh:
        fh.write(">r\nACGT\n")
    out = os.path.join(_build.BUILD_DIR, "cli_out")
    every = [torch.device("cuda", i) for i in range(
        torch.cuda.device_count())]
    for ndev, want in (("-1", every), ("1", None)):
        _run, params = cli.parse(["pipeline", "-fl_reads", reads,
                                  "-outfolder", out, "--devices", ndev])
        engine = cli.make_engine(params)
        check_card_engine(engine, "sharded (e)")
        got = params.device_mesh
        if got != want or engine.sharder.n != len(want or [0]):
            raise AssertionError("sharded (e): --devices %s gives the mesh "
                                 "%s and %d blocks, not %s"
                                 % (ndev, got, engine.sharder.n, want))
        log("sharded (e): --devices %s: %s" % (ndev, got or "no mesh, one "
                                               "block"))
    shutil.rmtree(out, ignore_errors=True)
    os.unlink(reads)


def phase_sharded(torch, np, _build, dev):
    """(a)-(e) on logical shards of the one card (the split, padding and
    gather; no cross-card launch).  The kernel launch counts of the main
    paths are kept: this phase counts its own and restores them.  Returns
    each kernel's max abs error from (a)."""
    saved = dict(_build.LAUNCHES)
    secs = {}
    t0 = time.perf_counter()
    cases = sharded_route_cases(np)
    errs = sharded_engine_routes(torch, np, _build, dev, cases)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = phase_main_path(torch, _build, dev, long_reads=True,
                               mesh=[dev, dev])
    log("sharded (b): launches on the long-read run on 2 shards: %s"
        % json.dumps(launches))
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_phase1(torch, _build, dev, [dev, dev])
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_seam(_build, dev, cases)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_cli(torch, _build)
    secs["e"] = time.perf_counter() - t0
    _build.LAUNCHES.update(saved)
    total = sum(secs.values())
    log("sharded phase: %s s, %.1f s in all (budget %d s)"
        % (", ".join("(%s) %.1f" % kv for kv in secs.items()), total,
           SHARDED_SECONDS))
    if total > SHARDED_SECONDS:
        raise AssertionError("sharded phase took %.1f s, over its %d s"
                             % (total, SHARDED_SECONDS))
    return errs


def _time(torch, fn, reps):
    """Mean ms of ``reps`` calls (CUDA events) and the last call's result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def myers_batch(torch, np, myers, dev, B, hw=False, L=2048):
    """K1's (``hw``: K2's) timed input: B pairs cycled over the 4096 of
    ``myers_pairs`` (K2: ``hw_pairs``), L = 2048, so a smaller B is the
    first B pairs of a larger one; K1's pair swapped so that n <= m, K2's as
    given.  Returns (pool, peq, qrow, trow, n, m), the last four int32."""
    B0 = 4096
    q, t, ql, tl = (hw_pairs if hw else myers_pairs)(np, B0, L)
    pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
    plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
    peq = myers.peq_table(pool, plen)
    ia = torch.arange(B, dtype=torch.int64, device=dev) % B0
    if hw:
        qrow, trow, n, m = ia, ia + B0, plen[ia], plen[ia + B0]
    else:
        qrow, trow, n, m = myers._swap(plen, ia, ia + B0)
    i32 = lambda x: x.to(torch.int32).contiguous()
    return pool, peq, i32(qrow), i32(trow), i32(n), i32(m)


def myers_columns(n, m, win, hw, L=2048):
    """The text columns each pair of lengths (n, m) needs of K1 (``hw``:
    K2) at window ``win`` and padded length L, int64: up to m (K2: none
    where m < jlow = max(n - 32 HALF, 1), since no column can then change
    its answer (n, 0)), or only up to J* = 32 x (nword + HALF + 1), where
    row n's word leaves the window, if the window moves below it
    (nwords - WIN > nword); later columns change nothing."""
    import torch

    n = n.to(torch.int64)
    m = m.to(torch.int64)
    half, nwords = win // 2, L // 32
    nword = torch.div(n - 1, 32, rounding_mode="floor")
    last = m
    if hw:
        jlow = (n - 32 * half).clamp(min=1)
        last = torch.where(m < jlow, torch.zeros_like(m), m)
    stop = torch.where(nwords - win > nword, 32 * (nword + half + 1), last)
    return torch.where(nword >= 0, torch.minimum(last, stop),
                       torch.zeros_like(last))


def _walk_entry(n, win):
    """The phase at which row n's word enters K2's window: 0 if nword <
    WIN, else nword - HALF."""
    import torch

    nword = torch.div(n.to(torch.int64) - 1, 32, rounding_mode="floor")
    return torch.where(nword < win, torch.zeros_like(nword),
                       nword - win // 2)


def hw_vote_share(n, m, win, L=2048):
    """(phases in which K2's warp vote fires, phases its warps run) when
    each 32 consecutive pairs form a warp: a warp runs until its longest
    lane's last phase (``myers_columns``), and its vote fires in a phase
    where a lane still in its sweep has row n's word in the window (from
    the phase ``_walk_entry`` on)."""
    import torch

    ph = torch.div(myers_columns(n, m, win, True, L) + 31, 32,
                   rounding_mode="floor")
    enter = _walk_entry(n, win)
    pad = (-ph.numel()) % 32
    ph = torch.cat([ph, ph.new_zeros(pad)])
    enter = torch.cat([enter, enter.new_zeros(pad)])
    p = torch.arange(int(ph.max()) if ph.numel() else 0, device=ph.device)
    run = p[None, :] < ph[:, None]
    walks = run & (p[None, :] >= enter[:, None])
    fired = walks.view(-1, 32, p.numel()).any(dim=1)
    warp_phases = run.view(-1, 32, p.numel()).any(dim=1)
    return int(fired.sum()), int(warp_phases.sum())


def myers_work(n, m, win, hw, L=2048):
    """int32 operations of K1 (``hw``: K2) at window ``win`` and padded
    length L on pairs of lengths (n, m), over ``myers_columns``, in the ALU
    pipe's lanes that ``bound_ms`` divides by: the larger of the ALU-only
    operations and half of all (ALU-only and either pipe), since the ALU
    and FMA pipes take 128 lanes an SM together.  K2 walks row n on those
    columns where its word is in the window, from the phase
    ``_walk_entry`` gives."""
    import torch

    each = myers_columns(n, m, win, hw, L)
    cols = float(each.sum())
    alu = cols * win * MYERS_ALU_OPS_PER_WORD
    any_pipe = cols * (win * MYERS_ANY_OPS_PER_WORD + MYERS_ANY_OPS_PER_COLUMN)
    if hw:
        enter = _walk_entry(n, win)
        walked = float((each - 32 * enter).clamp(min=0).sum())
        alu += walked * MYERS_HW_WALK_ALU_OPS_PER_COLUMN
        any_pipe += walked * MYERS_HW_WALK_ANY_OPS_PER_COLUMN
    return max(alu, (alu + any_pipe) / 2)


def warp_balance(cols):
    """Share of a warp's issue slots its lanes use when each of the 32
    consecutive pairs of a warp sweeps ``cols`` columns in phases of 32 and
    the warp runs until its longest: sum of the lanes' phases over 32 x the
    warps' longest."""
    import torch

    ph = torch.div(cols.to(torch.int64) + 31, 32, rounding_mode="floor")
    pad = (-ph.numel()) % 32
    ph = torch.cat([ph, ph.new_zeros(pad)]).view(-1, 32)
    longest = float(ph.max(dim=1).values.sum()) * 32
    return float(ph.sum()) / longest if longest else 1.0


def time_myers(torch, myers, batch, win, hw, reps=5):
    """K1 (``hw``: K2) at window ``win`` on ``myers_batch``'s pairs: (kernel
    ms, the last call's result, bytes, int32 operations, shape).  The ms is
    the mean of ``reps``
    calls after a warm-up (CUDA events); bytes: the pool and Peq table read
    once, four int32 a pair read and one (K2: two) written; operations:
    ``myers_work``."""
    pool, peq, qrow, trow, n, m = batch
    B, L = qrow.shape[0], pool.shape[1]
    call = lambda: myers._myers_cuda(pool, peq, qrow, trow, n, m, L=L,
                                     win=win, full=False, hw=hw)
    call()
    ms, got = _time(torch, call, reps)
    nbytes = pool.numel() + peq.numel() * 4 + B * 4 * 4 + B * (8 if hw else 4)
    return (ms, got, nbytes, myers_work(n, m, win, hw, L),
            "B=%d win=%d" % (B, win))


STATIC_GRAPH_SECONDS = 15   # the static graph step's budget
STATIC_GRAPH_WIN = 7


def static_graph_batch(np, candidates_fa):
    """The K2 pairs of phase 2's static graph (``pipeline/stat_filter.py``
    -> ``graph/end_invariant.py::ends_ignored_nn_graph``) on the candidates
    in ``candidates_fa`` (phase 1's ``candidates_converged.fa``), from the
    port's ``static_graph_pairs`` with the default ignore_ends_len.
    Returns (codes uint8 [R, W], lens int32 [R], ia int32 [P], ib int32
    [P]): row i holds the i-th candidate in length order (W: the engine's
    pool width for the longest), pair k is query row ia[k] in target row
    ib[k], in the graph's order."""
    from isocon_tpu_torch.graph.end_invariant import static_graph_pairs
    from isocon_tpu_torch.io import read_fasta
    from isocon_tpu_torch.ops.encode import encode_seq
    from isocon_tpu_torch.ops.engine import _pool_widths
    from isocon_tpu_torch.params import Params

    cands = {acc: seq for acc, seq in read_fasta(candidates_fa)}
    ordered, wanted = static_graph_pairs(cands, Params().ignore_ends_len)
    lens = np.array([len(seq) for seq, _acc in ordered], np.int32)
    w = np.asarray(wanted, np.int32).reshape(-1, 2)
    codes = np.full((len(ordered), int(_pool_widths(lens.max()))), 6,
                    np.uint8)
    for i, (seq, _acc) in enumerate(ordered):
        codes[i, :len(seq)] = encode_seq(seq).view(np.uint8)
    return codes, lens, w[:, 0].copy(), w[:, 1].copy()


def write_static_graph(path):
    """``static_graph_batch`` of the 10k workload's phase-1 candidates, saved
    to ``path`` (npz, keys codes, lens, ia, ib): runs ``get_candidates`` on
    the card on the 10,000 reads of ``workload.write_reads`` first."""
    import numpy as np
    from isocon_tpu_torch import cli
    from isocon_tpu_torch.ops import _build
    from isocon_tpu_torch.workload import write_reads

    work = os.path.join(_build.BUILD_DIR, "static_graph")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    reads = os.path.join(work, "reads.fa")
    write_reads(reads, N_READS)
    out = os.path.join(work, "out")
    run, params = cli.parse(["get_candidates", "-fl_reads", reads,
                             "-outfolder", out, "--device", "cuda"])
    run(params)
    codes, lens, ia, ib = static_graph_batch(
        np, os.path.join(out, "candidates_converged.fa"))
    np.savez(path, codes=codes, lens=lens, ia=ia, ib=ib)
    shutil.rmtree(work, ignore_errors=True)


def static_graph_launches(torch, np, myers, dev, batch):
    """``static_graph_batch``'s pairs as the engine launches them: every
    pair at win 7 (no pair of the graph goes to a wider window: the
    lengths of a pair differ by at most 40, so an uncertified pair's floor
    at win 7 is at least 28, above the cap of 25), grouped by pool width
    (``_pool_widths`` of the longer sequence, narrowest first) and cut into
    chunks of ``ED_BATCH`` in the graph's order.  Yields ``time_myers``'
    batches (pool, peq, qrow, trow, n, m) on ``dev``; a group's pool holds
    every row, cut to its width (rows longer than it are not read)."""
    from isocon_tpu_torch.ops.engine import ED_BATCH, _pool_widths

    codes, lens, ia, ib = batch
    widths = _pool_widths(np.maximum(lens[ia], lens[ib]))
    plen = torch.from_numpy(lens).to(dev)
    for Lb in np.unique(widths).tolist():
        pool = torch.from_numpy(np.ascontiguousarray(codes[:, :Lb])).to(dev)
        peq = myers.peq_table(pool, plen)
        sel = np.flatnonzero(widths == Lb)
        for s in range(0, sel.size, ED_BATCH):
            pick = sel[s:s + ED_BATCH]
            qrow = torch.from_numpy(ia[pick]).to(dev)
            trow = torch.from_numpy(ib[pick]).to(dev)
            yield pool, peq, qrow, trow, plen[qrow.long()], plen[trow.long()]


def time_static_graph(torch, np, myers, dev, clock_mhz, launches_run):
    """K2 on the 10k run's own launches: the static graph of its phase-1
    candidates (kept by ``phase_main_path``), launched as the engine does
    (``static_graph_launches``), each launch timed (``time_myers``) and
    held to ``myers_hw_plain`` on every entry, with its columns
    (``myers_columns``), ``warp_balance``, the share of a warp's phases in
    which the vote fires (``hw_vote_share``) and its bound.  Fails if the
    launches are not the run's ``launches_run`` or the step takes more than
    ``STATIC_GRAPH_SECONDS``.  Returns the reading over all launches (ms,
    plain ms, bound summed; bound_by that of the launch with the largest
    bound) and the max abs error."""
    from isocon_tpu_torch.ops import _build

    t0 = time.perf_counter()
    batch = static_graph_batch(np, os.path.join(_build.BUILD_DIR,
                                                CANDIDATES_10K))
    win, total, bys = STATIC_GRAPH_WIN, [0.0, 0.0, 0.0], []
    err = k = 0
    for k, chunk in enumerate(static_graph_launches(torch, np, myers, dev,
                                                    batch), 1):
        ms, got, nbytes, ops, shape = time_myers(torch, myers, chunk, win,
                                                 True)
        pool, peq, qrow, trow, n, m = chunk
        plain_ms, want = _time(torch, lambda: myers.myers_hw_plain(
            peq[qrow.long()], pool[trow.long()], n, m, L=pool.shape[1],
            win=win), 1)
        err = max(err, check_equal("myers_hw static graph " + shape,
                                   list(got), list(want)))
        bms, by = bound_ms(nbytes, ops, clock_mhz)
        cols = myers_columns(n, m, win, True, pool.shape[1])
        fired, phases = hw_vote_share(n, m, win, pool.shape[1])
        log("myers_hw static graph launch %d: %s L=%d, %d columns, "
            "warp_balance %.4f, vote fires in %d of %d warp phases (%.4f); "
            "kernel %.3f ms, plain %.1f ms, bound %.3f ms (%s), %.2fx the "
            "bound; equal to the plain version on every entry"
            % (k, shape, pool.shape[1], int(cols.sum()), warp_balance(cols),
               fired, phases, fired / max(phases, 1), ms, plain_ms, bms, by,
               ms / bms))
        for i, x in enumerate((ms, plain_ms, bms)):
            total[i] += x
        bys.append((bms, by))
        del chunk, pool, peq, got, want
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log("myers_hw static graph: %d candidates, %d pairs in %d launches "
        "(the 10k run's: %d); kernel %.3f ms, plain %.1f ms, bound %.3f ms, "
        "%.2fx the bound; %.1f s (budget %d s)"
        % (batch[0].shape[0], batch[2].shape[0], k, launches_run, total[0],
           total[1], total[2], total[0] / total[2], secs,
           STATIC_GRAPH_SECONDS))
    if k != launches_run:
        raise AssertionError("static graph: %d K2 launches, the 10k run "
                             "made %d" % (k, launches_run))
    if secs > STATIC_GRAPH_SECONDS:
        raise AssertionError("static graph step: %.1f s, over %d s"
                             % (secs, STATIC_GRAPH_SECONDS))
    return dict(ms=total[0], plain_ms=total[1], bound_ms=total[2],
                bound_by=max(bys)[1],
                shape="10k static graph, %d launches" % k), err


def k5_chunk(torch, np, dev):
    """K5's timed input, the engine's chunk: ``WAVE_BATCH`` pairs cycled
    over the noisy 16.5-20 kb copies of ``wavefront_long_pairs`` (seed 7)
    in a 32,768-wide pool.  Returns (pool, plen, qrow, trow)."""
    from isocon_tpu_torch.ops.engine import WAVE_BATCH

    L, B0 = 32768, 96
    q, t, ql, tl = wavefront_long_pairs(np, B0, L, seed=7)
    noisy = np.array([b for b in range(8, B0) if b % 6 < 3])
    pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
    plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
    qrow = torch.from_numpy(noisy).to(dev)[
        torch.arange(WAVE_BATCH, device=dev) % len(noisy)]
    return pool, plen, qrow, qrow + B0


def time_k5(torch, wavefront, chunk, Wp, hw_mode):
    """K5 at band Wp on ``k5_chunk``'s pairs: (kernel ms, the result, bytes,
    int32 operations, shape).  The ms is the mean of 3 calls after a
    warm-up (CUDA events); bytes and operations are what ``bound_ms``
    counts: the pool, the indices and lengths read and (ed, end_j) written;
    ``WAVEFRONT_OPS_PER_CELL`` over (n + m - 1) * Wp/2 cells and the
    per-diagonal operations."""
    pool, plen, qrow, trow = chunk
    B = qrow.shape[0]
    k5 = lambda: wavefront.banded_ed_pool(pool, plen, qrow, trow, Wp=Wp,
                                          hw_mode=hw_mode)
    k5()
    ms, got = _time(torch, k5, 3)
    diagonals = float((plen[qrow] + plen[trow] - 1).to(torch.float64).sum())
    per_diagonal = WAVEFRONT_OPS_PER_DIAGONAL + (
        WAVEFRONT_HW_OPS_PER_DIAGONAL if hw_mode else 0)
    ops = diagonals * ((Wp // 2) * WAVEFRONT_OPS_PER_CELL + per_diagonal)
    nbytes = pool.numel() + B * 4 * 4 + B * 8
    return ms, got, nbytes, ops, "B=%d Wp=%d L=%d" % (B, Wp, pool.shape[1])


def k3_batch(torch, np, dev, B, chunk=None):
    """K3's timed input: B pairs cycled over ``affine_pairs``' 512 (seed 2,
    L = 2048), or, given ``k5_chunk``'s chunk, its first B pairs (noisy
    16.5-20 kb copies, L = 32,768); match 2, mismatch -1/-2/-4 in turn,
    open 2, extend 0.  Returns (pool, ia, ib, n, m, ma, mi, go, ge)."""
    if chunk is None:
        B0 = 512
        q, t, ql, tl = affine_pairs(np, B0, 2048)
        pool = torch.from_numpy(np.concatenate([q, t])).to(dev)
        plen = torch.from_numpy(np.concatenate([ql, tl])).to(dev)
        ia = torch.arange(B, dtype=torch.int64, device=dev) % B0
        ib = ia + B0
    else:
        pool, plen, qrow, trow = chunk
        ia, ib = qrow[:B], trow[:B]
    k = torch.arange(B, device=dev)
    ma = torch.full((B,), 2, dtype=torch.int32, device=dev)
    mi = torch.tensor([-1, -2, -4], dtype=torch.int32, device=dev)[k % 3]
    go = torch.full((B,), 2, dtype=torch.int32, device=dev)
    ge = torch.zeros(B, dtype=torch.int32, device=dev)
    return pool, ia, ib, plen[ia], plen[ib], ma, mi, go, ge


def time_k3(torch, acu, batch, Wp, warps=0):
    """K3 at band Wp on ``k3_batch``'s pairs: (kernel ms, the result, bytes,
    int32 operations, shape), as ``time_k5`` gives them.  ``warps``: the
    register kernel's warps a pair (0: the launch size chooses, as on the
    main path).  Bytes: the code bytes of both sequences and eight int32 a
    pair read, a direction byte a cell and (best, ei, ej) written;
    operations: ``AFFINE_OPS_PER_CELL`` over (n + m - 1) * Wp/2 cells and
    ``AFFINE_OPS_PER_DIAGONAL`` over n + m - 1 diagonals."""
    pool, ia, ib, n, m, ma, mi, go, ge = batch
    B = ia.shape[0]
    if warps:
        k3 = lambda: acu.affine_fwd_cuda(pool, ia, ib, n, m, ma, mi, go, ge,
                                         Wp=Wp, warps=warps)
    else:       # the wrapper, which an older tree (kernel_time --root) has
        k3 = lambda: acu.affine_fwd(pool, ia, ib, n, m, ma, mi, go, ge,
                                    Wp=Wp)
    k3()
    ms, got = _time(torch, k3, 3)
    diagonals = float((n + m - 1).to(torch.float64).sum())
    cells = diagonals * (Wp // 2)
    nbytes = (float((n + m).to(torch.float64).sum()) + B * 4 * 8 + cells
              + B * 12)
    ops = cells * AFFINE_OPS_PER_CELL + diagonals * AFFINE_OPS_PER_DIAGONAL
    shape = "B=%d Wp=%d L=%d" % (B, Wp, pool.shape[1])
    return ms, got, nbytes, ops, shape + (" warps=%d" % warps if warps else "")


def rows_to_length(torch, walk):
    """``affine_walk``'s outputs with the bytes of each aligned row past
    its length (which the card leaves unwritten) zeroed, as
    ``sg_rows_plain`` gives them."""
    ops, fi, fj, ov, a1, a2, alen, nmat, nmis = walk
    keep = (torch.arange(a1.shape[1], device=a1.device)[None, :]
            < alen.long()[:, None])
    return [ops, fi, fj, ov, torch.where(keep, a1, 0),
            torch.where(keep, a2, 0), alen, nmat, nmis]


def plain_walk_rows(affine, dirs, ei, ej, Wp, nops, seqs):
    """``sg_walk_plain`` and ``sg_rows_plain`` of its walks: the plain
    version of ``affine_walk``'s nine outputs."""
    pool, qrow, trow, n, m = seqs
    walk = list(affine.sg_walk_plain(dirs, ei, ej, Wp, nops))
    return walk + list(affine.sg_rows_plain(
        *walk[:1], ei, ej, *walk[1:], pool[qrow.long()], pool[trow.long()],
        n, m, nops - 1))


def time_k4(torch, acu, dirs, ei, ej, Wp, nops, shape, seqs):
    """K4 on K3's direction bytes, with its epilogue, the aligned rows of
    ``seqs`` = (pool, qrow, trow, n, m), as the main path launches it:
    (kernel ms, the result, bytes, int32 operations, chain steps, shape),
    the ms the mean of 3 calls after a warm-up, the result
    ``rows_to_length``'s.  ``seqs`` None: a tree whose K4 writes no rows
    (``kernel_time.py --root``), the walk alone.  A walk's steps are the
    opcodes of its row that are not OP_NONE.  Bytes: a direction byte a
    step and (ei, ej) read, the ops rows and (fi, fj, ov) written; the
    epilogue's: the opcodes read back, the n + m bases, (qrow, trow, n, m)
    read, both rows' bytes up to their length and (alen, nmat, nmis)
    written.  Operations: ``WALK_OPS_PER_STEP`` a step; chain: the longest
    walk's steps (``bound_ms``)."""
    if seqs is None:
        k4 = lambda: acu.affine_walk(dirs, ei, ej, Wp=Wp, nops=nops)
    else:
        k4 = lambda: acu.affine_walk(dirs, ei, ej, Wp=Wp, nops=nops,
                                     seqs=seqs)
    k4()
    ms, got = _time(torch, k4, 3)
    B = ei.shape[0]
    per_pair = (got[0] != 0).sum(dim=1)
    steps = float(per_pair.to(torch.float64).sum())
    chain = int(per_pair.max()) if B else 0
    nbytes = steps + B * 8 + B * nops + B * 12
    if seqs is not None:
        got = rows_to_length(torch, got)
        n, m = seqs[3], seqs[4]
        nbytes += (steps + float((n + m).to(torch.float64).sum()) + B * 16
                   + 2 * float(got[6].to(torch.float64).sum()) + B * 12)
    return ms, got, nbytes, steps * WALK_OPS_PER_STEP, chain, shape


def time_k3_mean_launch(torch, acu, batch, Wp, B, nops, wants, res, name):
    """K3 on the first B pairs of ``batch`` (the run's mean launch size),
    into ``res[name]``, and K4's walk of its direction bytes with the rows,
    timed into ``res`` under the same name with ``affine_walk`` for
    ``affine_fwd``.  Each of ``wants`` is a (best, ei, ej, ops, fi, fj, ov,
    a1, a2, alen, nmat, nmis) of the batch's first k pairs that the
    launch's first k pairs are held to.  Returns the max abs error of K3
    and of K4."""
    part = tuple(x[:B] for x in batch[1:])
    ms, (best, ei, ej, dirs), nbytes, ops, shape = time_k3(
        torch, acu, (batch[0],) + part, Wp)
    res[name] = (ms, None, nbytes, ops, shape, 0)
    ms4, walk, nbytes, ops, chain, _ = time_k4(torch, acu, dirs, ei, ej, Wp,
                                               nops, shape,
                                               (batch[0],) + part[:4])
    res[name.replace("affine_fwd", "affine_walk")] = (ms4, None, nbytes, ops,
                                                      shape, chain)
    got = (best, ei, ej) + tuple(walk)
    del dirs
    err3 = err4 = 0
    for want in wants:
        k = want[0].shape[0]
        err3 = max(err3, check_equal("K3 " + shape,
                                     [x[:k] for x in got[:3]], want[:3]))
        err4 = max(err4, check_equal("K3+K4 " + shape,
                                     [x[:k] for x in got[3:]], want[3:]))
    return err3, err4


def plain_on_distinct_pairs(torch, wavefront, pool, plen, qrow, trow, *, Wp,
                            hw_mode):
    """``banded_ed_plain`` of a batch of pool-row pairs, run once on each
    distinct (query row, target row) and spread back to every entry: the
    plain result of the whole batch at the cost of its distinct pairs."""
    R = pool.shape[0]
    key, inv = torch.unique(qrow.long() * R + trow.long(),
                            return_inverse=True)
    uq, ut = key // R, key % R
    ed, ej = wavefront.banded_ed_plain(
        pool[uq], pool[ut], plen[uq], plen[ut], Wp=Wp, hw_mode=hw_mode,
        small=Wp <= wavefront.SMALL_WP)
    return ed[inv], ej[inv]


def time_long_shapes(torch, np, affine, acu, wavefront, dev, res):
    """K5 on ``k5_chunk`` (band 128 NW and HW, band 256 NW) and K3/K4 at the
    long run's shape (band 512, 512 pairs of the same copies; K3 also on
    its first 119), into ``res`` as ``phase_timing`` keeps them, each held
    to its plain version: K5 on every entry, K3/K4 of both launches on the
    batch's first pairs.  Returns the max abs error of each kernel."""
    # K5 -------------------------------------------------------------------
    chunk = k5_chunk(torch, np, dev)
    pool, plen, qrow, trow = chunk
    n, m = plen[qrow], plen[trow]
    err5 = 0
    for Wp, hw_mode, name in (
            (128, False, "wavefront_ed"), (128, True, "wavefront_ed (HW)"),
            (256, False, "wavefront_ed Wp=256")):
        ms, got, nbytes, ops, shape = time_k5(torch, wavefront, chunk, Wp,
                                              hw_mode)
        t0 = time.perf_counter()
        plain_ms = None
        if Wp == 128:      # the plain version, timed on the whole chunk
            plain_ms, want = _time(torch, lambda: wavefront.banded_ed_plain(
                pool[qrow], pool[trow], n, m, Wp=Wp, hw_mode=hw_mode,
                small=True), 1)
        else:
            want = plain_on_distinct_pairs(torch, wavefront, pool, plen, qrow,
                                           trow, Wp=Wp, hw_mode=hw_mode)
        err5 = max(err5, check_equal("K5 %s" % shape, got, want))
        log("K5 %s %s, the timed chunk: (ed, end_j) equal to the plain "
            "version on every entry (%.1f s)" % ("HW" if hw_mode else "NW",
                                                 shape,
                                                 time.perf_counter() - t0))
        res[name] = (ms, plain_ms, nbytes, ops, shape, 0)

    # K3 / K4 at the long run's shape: align_pairs on the 32,768-wide pool
    Wp, S = 512, 12
    batch = k3_batch(torch, np, dev, 512, chunk)
    pool, ia, ib, n, m, ma, mi, go, ge = batch
    B = ia.shape[0]
    nops = int((n + m).max()) + 1
    ms3, (best, ei, ej, dirs), nbytes, ops, shape = time_k3(torch, acu,
                                                            batch, Wp)
    res["affine_fwd (long)"] = (ms3, None, nbytes, ops, shape, 0)
    ms4, walk, nbytes, ops, chain, _ = time_k4(torch, acu, dirs, ei, ej, Wp,
                                               nops, shape, batch[:5])
    res["affine_walk (long)"] = (ms4, None, nbytes, ops, shape, chain)
    del dirs
    torch.cuda.empty_cache()
    # held to the plain versions on the batch's first S pairs: the plain
    # forward and walk cost a step per diagonal (some 37,000 here), not B.
    # K4's walk and rows of K3's direction bytes are held to the plain
    # forward + walk + rows, which holds the bytes on the path too (K4 alone
    # on the same bytes is held at L = 2048, phase_check_affine).
    t0 = time.perf_counter()
    s = slice(0, S)
    pb, pei, pej, pdirs = affine.sg_forward_plain(
        pool[ia[s]], pool[ib[s]], n[s], m[s], ma[s], mi[s], go[s], ge[s], Wp)
    plain = (pb, pei, pej) + tuple(plain_walk_rows(
        affine, pdirs, pei, pej, Wp, nops, (pool, ia[s], ib[s], n[s], m[s])))
    del pdirs
    err3 = check_equal("K3 " + shape, [best[s], ei[s], ej[s]], plain[:3])
    err4 = check_equal("K3+K4 " + shape, [x[s] for x in walk], plain[3:])
    log("K3+K4 %s, the first %d pairs of the timed batch: equal to the "
        "plain versions on every entry, the rows up to their length "
        "(%.1f s)" % (shape, S, time.perf_counter() - t0))
    # the long run's mean launch, 119 pairs (K3 four warps a pair): its
    # first S pairs held to the same plain results, all 119 to the 512-pair
    # launch (K3 one warp a pair)
    Bm = 119
    kernel = tuple(x[:Bm] for x in (best, ei, ej) + tuple(walk))
    e3, e4 = time_k3_mean_launch(torch, acu, batch, Wp, Bm, nops,
                                 [plain, kernel], res,
                                 "affine_fwd (long) B=%d" % Bm)
    log("K3+K4 B=%d Wp=%d, the long run's mean launch: its first %d pairs "
        "equal to the plain versions, all to the %d-pair launch"
        % (Bm, Wp, S, B))
    del walk, kernel
    torch.cuda.empty_cache()
    return {"affine_fwd": max(err3, e3), "affine_walk": max(err4, e4),
            "wavefront_ed": err5}


def phase_timing(torch, np, myers, affine, acu, wavefront, dev, clock_mhz):
    """Kernel and plain-version times at the main paths' shapes: K1 and K2
    at win 7 on a 262,144-pair chunk (the engine's ED chunk,
    ``myers_batch``), K3/K4 at band 256 on an 8192-pair batch (the engine's
    alignment batch), L = 2048; K5
    at band 128 on a 16,384-pair chunk (the engine's K5 chunk) of noisy
    16.5-20 kb copies, L = 32,768, NW and HW.  Kernel times only: K5 NW at
    band 256 on the same chunk, K3/K4 at the long run's shape (band 512 on
    a 512-pair batch of such copies, L = 32,768) and K3/K4 at the runs' mean
    launch sizes (the first 917 pairs of the 8192, the first 119 of the
    512).  K4 runs with its epilogue, the aligned rows, as the main path
    launches it.  Each reading of K3, K4 and K5 is also held to the plain
    version: on every entry (K5; K3 and K4's walk of its bytes and its
    rows, up to each row's length, on the 8192-pair batch and its first
    917), or on the first pairs of the batch (K3/K4 at
    the long shape, on 512 and on 119 pairs; all 119 are also held to the
    512-pair launch).  K1 and K2 are held to theirs on every entry of the
    timed chunk.  Returns the readings and the max abs error of each kernel
    so held."""
    res = {}
    myers_errs = {}

    # K1 and K2 at win 7 on the engine's ED chunk -------------------------
    L, B, win = 2048, 262144, 7
    for name, hw in (("myers_ed", False), ("myers_hw", True)):
        batch = myers_batch(torch, np, myers, dev, B, hw)
        ms, got, nbytes, ops, shape = time_myers(torch, myers, batch, win, hw)
        pool, peq, qrow, trow, n, m = batch
        plain = myers.myers_hw_plain if hw else myers.myers_ed_plain
        plain_ms, want = _time(torch, lambda: plain(
            peq[qrow.long()], pool[trow.long()], n, m, L=L, win=win), 1)
        res[name] = (ms, plain_ms, nbytes, ops, shape, 0)
        myers_errs[name] = check_equal(
            "%s %s" % (name, shape), list(got) if hw else [got],
            list(want) if hw else [want])
        cols = myers_columns(n, m, win, hw, L)
        vote = ("; vote fires in %d of %d warp phases"
                % hw_vote_share(n, m, win, L) if hw else "")
        log("%s %s, the timed chunk: equal to the plain version on every "
            "entry; %d columns, warp_balance %.4f%s"
            % (name, shape, int(cols.sum()), warp_balance(cols), vote))
        del batch, pool, peq, got, want
        torch.cuda.empty_cache()

    # K3 / K4 --------------------------------------------------------------
    Wp = 256
    batch = k3_batch(torch, np, dev, 8192)
    pool, ia, ib, n, m, ma, mi, go, ge = batch
    B = ia.shape[0]
    nops = int((n + m).max()) + 1
    ms3, (best, ei, ej, dirs), nbytes, ops, shape = time_k3(torch, acu,
                                                            batch, Wp)
    res["affine_fwd"] = (ms3, None, nbytes, ops, shape, 0)
    ms4, walk, nbytes, ops, chain, _ = time_k4(
        torch, acu, dirs, ei, ej, Wp, nops, shape, batch[:5])
    res["affine_walk"] = (ms4, None, nbytes, ops, shape, chain)
    del dirs
    torch.cuda.empty_cache()
    plain3, (pb, pei, pej, pdirs) = _time(torch, lambda: (
        affine.sg_forward_plain(pool[ia], pool[ib], n, m, ma, mi, go, ge,
                                Wp)), 1)
    plain4, pwalk = _time(torch, lambda: plain_walk_rows(
        affine, pdirs, pei, pej, Wp, nops, batch[:5]), 1)
    del pdirs
    torch.cuda.empty_cache()
    res["affine_fwd"] = (ms3, plain3) + res["affine_fwd"][2:]
    res["affine_walk"] = (ms4, plain4) + res["affine_walk"][2:]
    err3 = check_equal("K3 " + shape, [best, ei, ej], [pb, pei, pej])
    err4 = check_equal("K3+K4 " + shape, walk, pwalk)
    log("K3+K4 %s, the timed batch: equal to the plain versions on every "
        "entry, the rows up to their length" % shape)
    del walk
    # the 10k run's mean launch: 917 pairs, held to the same plain results
    Bm = 917
    e3, e4 = time_k3_mean_launch(
        torch, acu, batch, Wp, Bm, nops,
        [tuple(x[:Bm] for x in (pb, pei, pej) + tuple(pwalk))], res,
        "affine_fwd B=%d" % Bm)
    err3, err4 = max(err3, e3), max(err4, e4)
    del pwalk

    errs = time_long_shapes(torch, np, affine, acu, wavefront, dev, res)
    errs["affine_fwd"] = max(errs["affine_fwd"], err3)
    errs["affine_walk"] = max(errs["affine_walk"], err4)
    errs.update(myers_errs)

    out = {}
    for name, (kms, pms, nbytes, ops, shape, chain) in res.items():
        bms, by = bound_ms(nbytes, ops, clock_mhz, chain)
        out[name] = dict(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         shape=shape)
        log("%-19s %s: kernel %.3f ms, plain %s, bound %.3f ms (%s), "
            "%.2fx the bound"
            % (name, shape, kms, "not timed" if pms is None else
               "%.1f ms" % pms, out[name]["bound_ms"], out[name]["bound_by"],
               kms / out[name]["bound_ms"]))
    return out, errs


def time_sketch(torch, sk, p, lens, want, clock_mhz, k=20):
    """K6 at the shape of ``p`` (N rows, all in one launch of each kernel),
    mean ms of 5 calls after a warm-up (CUDA events), each reading held to
    the plain scores ``want``:
    - the fused function (``topn_scores``: first pass and merge) and the
      path it replaced (the scores entry in ``ROW_CHUNK``-row chunks, each
      chunk's ``topn`` sort), in turns: fused, replaced, replaced, fused;
    - the first pass alone (``sketch_topn``), the merge alone, the scores
      entry alone (all N rows);
    - the plain versions once: the plain scores (``sketch_plain_chunks``),
      their segments' ``segment_topn_plain`` (the two make
      ``sketch_topn_plain``) and ``merge_topn_plain``;
    - the library calls, comparators only (the port never makes them):
      ``torch.matmul(p, p.T)`` in float32 without TF32 minus the length
      differences and 1e9 on the diagonal (the scores), then
      ``torch.topk(k)`` (the function; the first pass's yardstick), and
      ``torch.topk(k)`` of the first pass's [N, segments x k] lists (the
      merge's); how many top-k lists differ from K6's is logged.
    Bounds: the function moves p and the lengths in and [N, k] values and
    int64 indices out, and does D fmas and ``SKETCH_OPS_PER_OUTPUT`` a
    distinct score, N(N - 1)/2 of them (the diagonal excluded, score(i, j)
    = score(j, i) bit for bit), at the float32 FMA rate; the first pass
    writes its [N, segments, k] lists instead; the merge moves the lists in
    and [N, k] out and does a compare a listed pair; the scores entry
    writes the [N, N] scores.
    Returns ({name: reading} of the three entries and of the fused
    function, "fused"; {name: max abs error})."""
    N, D = p.shape
    nseg = sk.plan_segments(
        N, torch.cuda.get_device_properties(p.device).multi_processor_count)
    fused = lambda: sk.topn_scores(p, lens, k)
    replaced = lambda: [sk.topn(sk.sketch_scores(
        p, lens, r0, min(sk.ROW_CHUNK, N - r0)), k)
        for r0 in range(0, N, sk.ROW_CHUNK)]
    fused()
    replaced()
    turns = [_time(torch, fn, 5) for fn in (fused, replaced, replaced,
                                            fused)]
    fused_ms = [turns[0][0], turns[3][0]]
    replaced_ms = [turns[1][0], turns[2][0]]
    first = lambda: sk.sketch_topn(p, lens, k, nseg)
    first()
    first_ms, (pv, pi) = _time(torch, first, 5)
    merge = lambda: sk.merge_topn(pv, pi, k)
    merge()
    merge_ms, (mv, mi) = _time(torch, merge, 5)
    scores = lambda: sk.sketch_scores(p, lens, 0, N)
    scores()
    scores_ms, got = _time(torch, scores, 5)
    errs = {"sketch_scores": check_sketch(torch, sk, "timed launch N=%d" % N,
                                          got, want)}
    del got
    tv, ti = sk.topn(want, k)
    wv, wi = sk.segment_topn_plain(want, k, sk.segment_bounds(N, nseg))
    for what, (gv, gi), (ev, ei) in (
            ("fused function", turns[3][1], (tv, ti)),
            ("replaced path", (torch.cat([v for v, _i in turns[2][1]]),
                               torch.cat([i for _v, i in turns[2][1]])),
             (tv, ti)),
            ("sketch_topn", (pv, pi), (wv, wi)), ("sketch_merge", (mv, mi),
                                                  (tv, ti))):
        if not (torch.equal(gv.view(torch.int32), ev.view(torch.int32))
                and torch.equal(gi.to(torch.int64), ei.to(torch.int64))):
            raise AssertionError("K6 timed N=%d: the %s differs from the "
                                 "plain top-%d" % (N, what, k))
        if what.startswith("sketch"):
            errs[what] = float((gv - ev).abs().nan_to_num().max())
    # the plain first pass is the plain scores and their segments' topn
    # (``sketch_topn_plain``), timed as its two parts
    plain_scores_ms, plain = _time(torch, lambda: sketch_plain_chunks(
        torch, sk, p, lens), 1)
    plain_select_ms, _ = _time(torch, lambda: sk.segment_topn_plain(
        plain, k, sk.segment_bounds(N, nseg)), 1)
    del plain
    plain_first_ms = plain_scores_ms + plain_select_ms
    plain_merge_ms, _ = _time(torch, lambda: sk.merge_topn_plain(pv, pi, k),
                              1)
    ld = lens.to(torch.int64)

    def lib_scores():
        out = torch.matmul(p, p.t())
        out -= (ld[:, None] - ld[None, :]).abs().to(torch.float32)
        out.diagonal().sub_(1e9)
        return out

    lib_topn = lambda: torch.topk(lib_scores(), k, dim=1)
    lib_merge = lambda: torch.topk(pv.reshape(N, -1), k, dim=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = {}
        for name, fn in (("sketch_scores", lib_scores),
                         ("sketch_topn", lib_topn),
                         ("sketch_merge", lib_merge)):
            fn()
            lib[name] = _time(torch, fn, 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lib_i = lib["sketch_topn"][1].indices
    log("K6 N=%d: the library top-%d (torch.matmul without TF32, torch.topk) "
        "differs from K6's in %d of %d rows' lists; the library scores "
        "differ in %d of %d entries (max abs %g); comparators, not the "
        "function" % (N, k, int((lib_i != ti).any(dim=1).sum()), N,
                      int((lib["sketch_scores"][1] != want).sum()), N * N,
                      float((lib["sketch_scores"][1] - want).abs().max())))
    del lib_i
    ops = float(N) * (N - 1) / 2 * (D + SKETCH_OPS_PER_OUTPUT)
    inputs = N * D * 4 + N * 4
    shape = "N=%d D=%d k=%d segments=%d" % (N, D, k, nseg)
    out = {}
    for name, ms, plain_ms, nbytes, nops in (
            ("sketch_topn", first_ms, plain_first_ms,
             inputs + N * nseg * k * 8, ops),
            ("sketch_merge", merge_ms, plain_merge_ms,
             N * nseg * k * 8 + N * k * 12, float(N) * nseg * k),
            ("sketch_scores", scores_ms, plain_scores_ms,
             inputs + N * N * 4, ops),
            ("fused", min(fused_ms), plain_first_ms + plain_merge_ms,
             inputs + N * k * 12, ops)):
        bms, by = bound_ms(nbytes, nops, clock_mhz, lanes=FP32_LANES_PER_SM)
        library_ms = lib["sketch_topn" if name == "fused" else name][0]
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         shape=shape, library_ms=library_ms)
        log("%-19s %s: kernel %.3f ms, plain %.1f ms, library %.3f ms, "
            "bound %.3f ms (%s), %.2fx the bound"
            % (name, shape, ms, plain_ms, library_ms, bms, by, ms / bms))
    log("K6 N=%d in turns: the fused function %s ms, the replaced path (the "
        "scores entry in %d-row chunks + topn's sort) %s ms"
        % (N, " / ".join("%.3f" % x for x in fused_ms), sk.ROW_CHUNK,
           " / ".join("%.3f" % x for x in replaced_ms)))
    return out, errs


def kmer_profile_reads():
    """Job 0 (seed ``KMER_PROFILE_SEED``) of the benchmark cell
    ``nontargeted_pipeline``: 10,000 reads of nine gene families, 719-1,985
    bases (``portbench/configs/multi_family.json``,
    ``portbench/generator.make_job``)."""
    from portbench.generator import make_job

    with open(os.path.join(ROOT, "portbench", "configs",
                           "multi_family.json")) as fh:
        config = json.load(fh)
    return make_job(config, KMER_PROFILE_SEED, 0)[1]


def time_kmer_profile(torch, np, sk, dev, seqs, clock_mhz, reps=20):
    """K7 on the reads ``seqs`` (one launch over all N), mean ms of
    ``reps`` calls after a warm-up (CUDA events), held bit for bit to its
    plain version (``kmer_profiles_plain``, host clock, once) and to the
    per-read ``graph/sketch.py::kmer_profile`` stack and its square root
    (the path K7 replaced, host clock, once).  Bound: the bytes read once
    (the reads and their offsets) and the rows written once, over 3.35
    TB/s.  Returns (its reading, the max abs error: 0.0)."""
    from isocon_tpu_torch.graph.sketch import kmer_profile

    N = len(seqs)
    off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    raw = torch.from_numpy(np.frombuffer(bytearray("".join(seqs), "ascii"),
                                         dtype=np.uint8))
    off = torch.from_numpy(off)
    t0 = time.perf_counter()
    want = sk.kmer_profiles_plain(raw, off)
    t1 = time.perf_counter()
    loop = np.sqrt(np.stack([kmer_profile(s) for s in seqs]))
    t2 = time.perf_counter()
    if not np.array_equal(loop.view(np.int32), want.numpy().view(np.int32)):
        raise AssertionError("K7 N=%d: the plain version differs from the "
                             "per-read kmer_profile rows" % N)
    raw_d, off_d = raw.to(dev), off.to(dev)
    fn = lambda: sk.kmer_profiles(raw_d, off_d)
    fn()
    ms, got = _time(torch, fn, reps)
    got = got.cpu()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    err = float((got - want).abs().max())
    if differ or err:
        raise AssertionError("K7 N=%d: %d entries differ from the plain "
                             "version (max abs err %g)" % (N, differ, err))
    nbytes = raw.numel() + off.numel() * 8 + N * sk.DIM * 4
    bms, by = bound_ms(nbytes, 0, clock_mhz)
    shape = "N=%d bases=%d (mean %.1f)" % (N, raw.numel(), raw.numel() / N)
    log("%-19s %s: kernel %.4f ms, plain %.1f ms, per-read loop %.1f ms, "
        "bound %.4f ms (%s, %d bytes), %.2fx the bound; equal to the plain "
        "version on every entry" % ("kmer_profile", shape, ms,
                                    (t1 - t0) * 1e3, (t2 - t1) * 1e3, bms,
                                    by, nbytes, ms / bms))
    return dict(ms=ms, plain_ms=(t1 - t0) * 1e3, loop_ms=(t2 - t1) * 1e3,
                bound_ms=bms, bound_by=by, bytes=nbytes, shape=shape,
                library_ms=None), err


KERNELS = [
    ("myers_ed", "isocon_tpu_torch/csrc/myers_ed.cu",
     "isocon_tpu/ops/myers_pallas.py:359"),
    ("myers_hw", "isocon_tpu_torch/csrc/myers_ed.cu",
     "isocon_tpu/ops/myers_pallas.py:379"),
    ("affine_fwd", "isocon_tpu_torch/csrc/affine_sg.cu",
     "isocon_tpu/ops/affine_pallas_c.py:544"),
    ("affine_walk", "isocon_tpu_torch/csrc/affine_sg.cu",
     "isocon_tpu/ops/affine_pallas_c.py:606"),
    ("wavefront_ed", "isocon_tpu_torch/csrc/wavefront_ed.cu",
     "isocon_tpu/ops/wavefront_pallas.py:178"),
    # a jax.jit dot + top_k, not a pl.pallas_call: its scores and top-k
    # (the first pass), the merge of a row's lists, and the scores entry
    ("sketch_topn", "isocon_tpu_torch/csrc/sketch.cu",
     "isocon_tpu/graph/sketch.py:51"),
    ("sketch_merge", "isocon_tpu_torch/csrc/sketch.cu",
     "isocon_tpu/graph/sketch.py:62"),
    ("sketch_scores", "isocon_tpu_torch/csrc/sketch.cu",
     "isocon_tpu/graph/sketch.py:56"),
    # the profiles K6 reads, host numpy in the JAX package
    ("kmer_profile", "isocon_tpu_torch/csrc/sketch.cu",
     "isocon_tpu/graph/sketch.py:32"),
    # MAM vote and correction, host numpy in the JAX package: the chain of
    # both kernels, under the first one's name and launches
    ("consensus_vote", "isocon_tpu_torch/csrc/consensus.cu",
     "isocon_tpu/correct/dense.py:128"),
]


def pin_hash_seed() -> None:
    """Re-run this script with PYTHONHASHSEED=0 unless it is set so.  The
    row order of ``cluster_info.tsv`` follows the iteration order of sets
    of read accessions (``greedy_bipartite_assignment``, in the JAX
    package and in the port alike), which depends on the interpreter's
    string hash seed; the expected digest was made under seed 0
    (``tools/smoke_expect.py`` calls this function too)."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0")
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable] + sys.argv, env)


def main() -> None:
    pin_hash_seed()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    sys.path.insert(0, ROOT)
    from isocon_tpu_torch import native
    from isocon_tpu_torch.ops import (_build, affine, myers, oracle,
                                      wavefront)
    from isocon_tpu_torch.ops import sketch as sk
    from isocon_tpu_torch.ops import affine_cuda as acu
    from isocon_tpu_torch.ops import consensus as cons

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log("device: %s (torch %s, CUDA %s); nvidia-smi: %s; max SM clock %d MHz"
        % (name, torch.__version__, torch.version.cuda, smi, clock_mhz))

    phase_build(_build, native)
    err1 = phase_check_myers(torch, np, myers, dev)
    err2 = phase_check_myers_hw(torch, np, myers, oracle, dev)
    err3, err4 = phase_check_affine(torch, np, affine, acu, dev)
    err5 = phase_check_wavefront(torch, np, wavefront, oracle, dev)
    real = nontargeted_profiles(torch, np, dev, _build.BUILD_DIR)
    errs6, real_plain = phase_check_sketch(torch, np, sk, dev, real)
    # kept on the host while the pipelines run (their peak memory is read)
    real, real_plain = tuple(x.cpu() for x in real), real_plain.cpu()
    torch.cuda.empty_cache()
    consensus_reading, err7 = phase_check_consensus(torch, np, cons, dev,
                                                    clock_mhz)
    phase_engine_routes(torch, np, myers, wavefront, native, dev)
    errs = {"myers_ed": err1, "myers_hw": err2, "affine_fwd": err3,
            "affine_walk": err4, "wavefront_ed": err5, **errs6,
            "consensus_vote": err7}
    # each path sets the counts to 0 just before it runs (comparison
    # launches do not count); K5's count is the long-read run's, K6's the
    # nontargeted run's (its scores entry is for checking: 0 there)
    launches = phase_main_path(torch, _build, dev)
    long_launches = phase_main_path(torch, _build, dev, long_reads=True)
    launches["wavefront_ed"] = long_launches["wavefront_ed"]
    log("launches on the long-read run: %s" % json.dumps(long_launches))
    nt_launches = phase_main_path(torch, _build, dev, nontargeted=True)
    for kname in ("sketch_topn", "sketch_merge", "sketch_scores",
                  "kmer_profile"):
        launches[kname] = nt_launches[kname]
    log("launches on the nontargeted run: %s" % json.dumps(nt_launches))
    for kname, err in phase_sharded(torch, np, _build, dev).items():
        errs[kname] = max(errs[kname], err)
    timing, timing_errs = phase_timing(torch, np, myers, affine, acu,
                                       wavefront, dev, clock_mhz)
    timing["consensus_vote"] = consensus_reading
    for kname, err in timing_errs.items():
        errs[kname] = max(errs[kname], err)
    # K2 at the main path's own launches (the 10k run's static graph): the
    # kernels line gives these, the log also the 262,144-pair chunk's
    timing["myers_hw"], err = time_static_graph(
        torch, np, myers, dev, clock_mhz, launches["myers_hw"])
    errs["myers_hw"] = max(errs["myers_hw"], err)
    # K6 at round 1's N and at the run's smallest round's (its first 1,102
    # unique reads)
    p, lens = (x.to(dev) for x in real)
    want = real_plain.to(dev)
    del real, real_plain
    for n in (p.shape[0], SMALLEST_ROUND):
        reading, k6_errs = time_sketch(
            torch, sk, p[:n].contiguous(), lens[:n].contiguous(),
            want[:n, :n].contiguous(), clock_mhz)
        for kname, err in k6_errs.items():
            errs[kname] = max(errs[kname], err)
        if n == p.shape[0]:
            timing.update(reading)
    del p, lens, want
    torch.cuda.empty_cache()
    # K7 at round 1's shape and at a later round's (the first 1,102 reads)
    seqs = kmer_profile_reads()
    for n in (len(seqs), SMALLEST_ROUND):
        reading, errs["kmer_profile"] = time_kmer_profile(
            torch, np, sk, dev, seqs[:n], clock_mhz)
        if n == len(seqs):
            timing["kmer_profile"] = reading

    kernels = []
    for kname, source, replaces in KERNELS:
        tm = timing[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            # this line names two limits; K4's chain is one of operations
            # (its steps' dependent latency), logged above as "chain"
            "bound_by": ("operations" if tm["bound_by"] == "chain"
                         else tm["bound_by"]),
            "library_ms": tm.get("library_ms"),
        })
    log("no library call computes K1-K5's functions: their library_ms is "
        "null")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
