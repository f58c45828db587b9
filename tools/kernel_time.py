#!/usr/bin/env python3
"""Time K1 / K2 (the banded Myers NW / HW edit distance), K3 (the affine
forward), K4 (its traceback walk), K5 (the banded wavefront), K6 (the
sketch scores' top-20), K7 (the sketch's k-mer profiles) or the consensus
chain (MAM vote and correction) of one tree of the port on the card.

K1 (``--kernel k1``): on ``chip_smoke.myers_batch``'s pairs (L = 2048) at
win 7 for 262,144 pairs (the engine's ED chunk and the table's shape),
153,670 (the 10k run's mean phase-1 launch: 13,830,282 pairs in 90) and
13,560 (its mean phase-2 launch: 488,165 in 36), and at win 9 for 262,144;
K2 (``--kernel k2``) at win 7 for 262,144 and on each launch of the 10k
run's static graph (``chip_smoke.static_graph_launches``: its phase-1
candidates' pairs at win 7 in the engine's chunks), with the share of
warp phases in which K2's vote fires; the static graph's pairs come from
``--static-graph FILE`` (npz), which this tree's
``chip_smoke.write_static_graph`` makes first, in a child process, if it
is missing (``get_candidates`` on the 10k workload, about a minute on the
card); or, with ``--pairs`` and ``--win``, those batch sizes at each
window.  K5 (``--kernel k5``): at
the engine's K5 chunk (``chip_smoke.k5_chunk``: 16,384 pairs of noisy
16.5-20 kb copies, L = 32,768), NW and HW, for each band asked for
(``--wp``, default 128 256).  K3 (``--kernel k3``): at the
two table shapes and the runs' mean launch sizes of ``chip_smoke.py``
(``chip_smoke.k3_batch``): 8192 and 917 pairs at band 256, L = 2048; 512
and 119 pairs of the chunk's copies at band 512, L = 32,768; or, with
``--pairs``, those batch sizes at each band of ``--wp`` (L = 32,768 with
``--long``, else 2048).  ``--warps`` times each K3 shape with each number
of warps a pair of the register kernel (1 or 4; 0, the default, lets the
launch size choose, as the main path does).  K4 (``--kernel k4``): at the
same shapes, K3 runs once for the direction bytes and only K4 is timed,
with its epilogue, the aligned rows, as the main path launches it
("walk+rows"; a tree whose K4 writes no rows: the walk, "walk").
The consensus chain (``--kernel consensus``): MAM correction's vote and
correction kernels on ``chip_smoke.consensus_round_inputs``' targeted and
long rounds (``chip_smoke.CONSENSUS_SHAPES``), both launches, then the vote
alone (the same round with no row to correct), held to the plain version
(``chip_smoke.time_consensus``); its bound is the MAM bytes read once.
K6 (``--kernel k6``): the tree's ``ops/sketch.py::topn_indices``,
the top-20 of the sketch scores as its main path computes them, on the
first round's profiles of the nontargeted run
(``chip_smoke.nontargeted_profiles``, N = 10,000) and on their first
1,102 rows (its smallest round's size); with ``--segments S ...`` also
the first pass alone
(``sketch_topn``) at each segment count the rows allow, beside
``plan_segments``' pick.  K7 (``--kernel k7``): the tree's
``ops/sketch.py::kmer_profiles`` on job 0 of the benchmark cell
``nontargeted_pipeline`` (``chip_smoke.kmer_profile_reads``: N = 10,000,
mean 1,165 bases, round 1's shape) and on its first 1,102 reads (a later
round's), with ``chip_smoke.time_kmer_profile``: held to the plain
version, whose time and the replaced per-read loop's the shape gives; its
bound is the bytes read and written once.  For each reading the kernel's
ms and its bound
with its limiting
term, as this tree's ``chip_smoke.time_k3`` / ``time_k4`` / ``time_k5``
(``time_myers`` for K1 / K2) and ``chip_smoke.bound_ms`` compute them;
for K1 / K2 the shape also gives ``chip_smoke.warp_balance`` of the
batch, the share of issue slots a warp's lanes use when a warp runs until
its longest pair ends.
Prints the card's name and power limit, the ptxas registers and spills of
the register kernels, of K4's walk kernel and of K1 / K2's band kernel, and
one JSON line per reading.  The result is not
checked here: ``chip_smoke.py`` holds it to the plain version at the same
shapes.

``--root DIR`` runs the kernel of the tree unpacked in DIR (its
``isocon_tpu_torch``) under this tree's timing and bound, so that two trees
are compared on one card in one call, in turns, one process each:

    python tools/kernel_time.py --kernel k4 --root OLD
    python tools/kernel_time.py --kernel k4
    python tools/kernel_time.py --kernel k4
    python tools/kernel_time.py --kernel k4 --root OLD
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K3's shapes: (pairs, band, on the long copies)
K3_SHAPES = ((8192, 256, False), (917, 256, False), (512, 512, True),
             (119, 512, True))
# K1's and K2's shapes: (pairs, window)
K1_SHAPES = ((262144, 7), (153670, 7), (13560, 7), (262144, 9))
K2_SHAPES = ((262144, 7),)


def static_graph(np, path):
    """``chip_smoke.static_graph_batch`` of the 10k run, from ``path``,
    made first with this tree's code (a child process) if it is missing."""
    if not os.path.exists(path):
        subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.write_static_graph(sys.argv[1])", path],
            cwd=HERE, env=dict(os.environ, PYTHONHASHSEED="0"), check=True)
    with np.load(path) as z:
        return tuple(z[k] for k in ("codes", "lens", "ia", "ib"))


def readings(cs, torch, np, dev, args):
    """(label, ms, bytes, operations, chain steps, shape) of each timed
    call."""
    if args.kernel == "consensus":
        from isocon_tpu_torch.ops import consensus

        for name in ("targeted", "long"):
            packed = cs.consensus_round_inputs(np, name)
            ms, _plain_ms, nbytes, _err, shape = cs.time_consensus(
                torch, np, consensus, dev, packed)
            yield "chain %s" % name, ms, nbytes, 0, 0, shape
            # the vote alone: the same round with no row to correct
            flat, table, deg, rows = packed
            ms, _plain_ms, nbytes, _err, shape = cs.time_consensus(
                torch, np, consensus, dev, (flat, table, deg, rows[:, :0]))
            yield "vote %s" % name, ms, nbytes, 0, 0, shape
        return
    if args.kernel == "k6":
        from isocon_tpu_torch.ops import _build, sketch

        p, lens = cs.nontargeted_profiles(torch, np, dev, _build.BUILD_DIR)
        N, D = p.shape
        for n in (N, cs.SMALLEST_ROUND):
            pn, ln = p[:n].contiguous(), lens[:n].contiguous()
            # p and the lengths in, [n, 20] float32 values and int64
            # indices out; D fmas and the two subtractions a distinct
            # score, n(n - 1)/2 of them (a score is symmetric)
            nbytes = n * D * 4 + n * 4 + n * 20 * 12
            ops = float(n) * (n - 1) / 2 * (D + cs.SKETCH_OPS_PER_OUTPUT)
            fn = lambda: sketch.topn_indices(pn, ln, 20)
            fn()
            ms, _got = cs._time(torch, fn, 5)
            yield "topn", ms, nbytes, ops, 0, "N=%d D=%d k=20" % (n, D)
            for nseg in args.segments or ():
                if nseg > min(-(-n // sketch.TILE), sketch.MAX_SEGMENTS):
                    continue
                fn = lambda: sketch.sketch_topn(pn, ln, 20, nseg)
                fn()
                ms, _got = cs._time(torch, fn, 5)
                yield ("first pass", ms, nbytes, ops, 0,
                       "N=%d D=%d k=20 segments=%d (plan %d)"
                       % (n, D, nseg, sketch.plan_segments(n, cs.SMS)))
        return
    if args.kernel == "k7":
        from isocon_tpu_torch.ops import sketch

        clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
        seqs = cs.kmer_profile_reads()
        for n in (len(seqs), cs.SMALLEST_ROUND):
            reading, _err = cs.time_kmer_profile(torch, np, sketch, dev,
                                                 seqs[:n], clock_mhz)
            yield "profiles", reading["ms"], reading["bytes"], 0, 0, (
                "%s; plain %.1f ms, per-read loop %.1f ms"
                % (reading["shape"], reading["plain_ms"],
                   reading["loop_ms"]))
        return
    if args.kernel in ("k1", "k2"):
        from isocon_tpu_torch.ops import myers

        hw = args.kernel == "k2"
        shapes = K2_SHAPES if hw else K1_SHAPES
        if args.pairs:
            shapes = [(B, w) for w in args.win or (7,) for B in args.pairs]
        batches = {}
        for B, win in shapes:
            if B not in batches:
                batches.clear()
                torch.cuda.empty_cache()
                batches[B] = cs.myers_batch(torch, np, myers, dev, B, hw)
            ms, _got, nbytes, ops, shape = cs.time_myers(
                torch, myers, batches[B], win, hw)
            _pool, _peq, _q, _t, n, m = batches[B]
            balance = cs.warp_balance(cs.myers_columns(
                n, m, win, hw, _pool.shape[1]))
            yield ("HW" if hw else "NW"), ms, nbytes, ops, 0, \
                "%s warp_balance=%.4f" % (shape, balance)
        if hw and not args.pairs:
            batches.clear()
            torch.cuda.empty_cache()
            win = cs.STATIC_GRAPH_WIN
            for k, chunk in enumerate(cs.static_graph_launches(
                    torch, np, myers, dev,
                    static_graph(np, args.static_graph)), 1):
                ms, _got, nbytes, ops, shape = cs.time_myers(
                    torch, myers, chunk, win, True)
                n, m, L = chunk[4], chunk[5], chunk[0].shape[1]
                cols = cs.myers_columns(n, m, win, True, L)
                yield "HW", ms, nbytes, ops, 0, (
                    "static graph launch %d: %s L=%d warp_balance=%.4f vote "
                    "fires in %d of %d warp phases"
                    % ((k, shape, L, cs.warp_balance(cols))
                       + cs.hw_vote_share(n, m, win, L)))
        return
    chunk = cs.k5_chunk(torch, np, dev)
    if args.kernel == "k5":
        from isocon_tpu_torch.ops import wavefront

        for Wp in args.wp or (128, 256):
            for hw_mode in (False, True):
                ms, _got, nbytes, ops, shape = cs.time_k5(
                    torch, wavefront, chunk, Wp, hw_mode)
                yield "HW" if hw_mode else "NW", ms, nbytes, ops, 0, shape
        return
    from isocon_tpu_torch.ops import affine_cuda as acu

    shapes = K3_SHAPES
    if args.pairs:
        shapes = [(B, Wp, args.long) for Wp in args.wp or (256,)
                  for B in args.pairs]
    for B, Wp, long_copies in shapes:
        batch = cs.k3_batch(torch, np, dev, B, chunk if long_copies else None)
        if args.kernel == "k4":
            _ms, (_best, ei, ej, dirs), _nb, _ops, shape = cs.time_k3(
                torch, acu, batch, Wp)
            nops = int((batch[3] + batch[4]).max()) + 1
            # with the epilogue, the aligned rows, where the tree's K4
            # writes them (as its main path launches it), else the walk
            rows = "seqs" in inspect.signature(acu.affine_walk).parameters
            ms, got, nbytes, ops, chain, shape = cs.time_k4(
                torch, acu, dirs, ei, ej, Wp, nops, shape,
                batch[:5] if rows else None)
            label = "walk+rows" if rows else "walk"
            yield label, ms, nbytes, ops, chain, shape
            del got, dirs
            torch.cuda.empty_cache()
            continue
        for warps in args.warps:
            ms, got, nbytes, ops, shape = cs.time_k3(torch, acu, batch, Wp,
                                                     warps)
            del got
            torch.cuda.empty_cache()
            yield "fwd", ms, nbytes, ops, 0, shape


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k4", "k5", "k6",
                                         "k7", "consensus"),
                    required=True)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--wp", type=int, nargs="+",
                    help="bands (K5: default 128 256; K3/K4: with --pairs, "
                    "default 256)")
    ap.add_argument("--pairs", type=int, nargs="+",
                    help="K1's, K2's, K3's (K4's) batch sizes in place of "
                    "the standard shapes")
    ap.add_argument("--win", type=int, nargs="+",
                    help="K1/K2 windows with --pairs (default 7)")
    ap.add_argument("--long", action="store_true",
                    help="K3/K4 with --pairs: the long copies, L = 32,768")
    ap.add_argument("--warps", type=int, nargs="+", default=[0],
                    help="K3's warps a pair (0: by launch size)")
    ap.add_argument("--static-graph", default=os.path.join(
        HERE, "isocon_tpu_torch", "_build", "static_graph_10k.npz"),
                    help="K2: the 10k static graph's pairs (npz), made "
                    "first if missing")
    ap.add_argument("--segments", type=int, nargs="+",
                    help="K6: also its first pass alone at each segment "
                    "count (this tree's sketch_topn)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs     # this tree's timing and bound
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)    # the kernel under test
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_time: no CUDA device")
    from isocon_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi("name,power.limit")
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    print(smi)
    _build.build_all()
    for kname, regs, spill in cs.register_kernel_report(_build.BUILD_LOG):
        print("register kernel %s: %d registers, %s" % (kname, regs, spill))
    for label, ms, nbytes, ops, chain, shape in readings(cs, torch, np, dev,
                                                         args):
        bound, by = cs.bound_ms(nbytes, ops, clock_mhz, chain, lanes=(
            cs.FP32_LANES_PER_SM if args.kernel == "k6"
            else cs.INT32_LANES_PER_SM))
        print(json.dumps({
            "tree": os.path.relpath(root, HERE), "kernel": args.kernel,
            "mode": label, "shape": shape, "ms": ms, "bound_ms": bound,
            "bound_by": by, "ratio": ms / bound, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
