"""Record the JAX package's ``pipeline`` results for ``chip_smoke.py``.

Generates a synthetic workload (``isocon_tpu_torch.workload``: the 10k-read
one, or with ``--long`` the long-read one), runs the
JAX package's ``pipeline`` on the CPU and prints one JSON line with the
sha256 of ``candidates_converged.fa``, ``final_candidates.fa`` and
``cluster_info.tsv``, the engine's volume counters (ED pairs and calls,
alignments and calls) at the end of phase 1 and at the end of the run, the
ED pairs of each call, and the number of pairs that survive the HW
prefilter of the static candidate graph.  ``chip_smoke.py`` holds the
port's run on the card to these numbers in
``isocon_tpu_torch/smoke_expect.json`` (the long-read run's line goes under
its ``"long"`` key).

The run pins PYTHONHASHSEED to 0 (``chip_smoke.pin_hash_seed`` says why).

``--nontargeted`` runs ``pipeline --nontargeted`` on the four-family
workload (``write_reads(path, N_READS, families=4)``) for the
``"nontargeted"`` key.  There the JAX package's sketch scores
(``isocon_tpu.graph.sketch._topn_scores``, a dot left to XLA) are replaced
at run time by ``topn_scores_sequential_fma``: the same function with its
sum fixed to one in-order chain of exact float32 fused multiply-adds per
entry, the order the port computes.  Nothing else changes.  XLA:CPU's own
order depends on the matrix's shape (``about`` in the JSON), so the
unpinned run is recorded beside it: its digests and, at every sketch call
of the pinned run, how many rows' top-n lists (in order, and as sets) the
unpinned function gives otherwise.

Usage: JAX_PLATFORMS=cpu python tools/smoke_expect.py [--long |
       --nontargeted] N_READS OUTDIR
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK_ROWS = 32


def _score_block(p, pt, lens, r0, r1):
    """float32 [r1 - r0, N] sketch scores of rows r0 .. r1 - 1: per entry
    acc = fmaf(p[i, d], p[j, d], acc) for d in order from 0.0, then minus
    |len_i - len_j| and, on the diagonal, minus 1e9.  The float64 sum of
    the float32 acc and the exact float64 product rounds to float32
    correctly except where it lands exactly on a float32 midpoint (low 29
    bits 1 followed by 28 zeros; the values here are 0 or >= 1, normal
    float32): there the TwoSum error says which side the exact sum lies
    on, and the sum moves one ulp to that side before it is rounded."""
    a = p[r0:r1]
    acc = np.zeros((r1 - r0, p.shape[0]))
    prod = np.empty_like(acc)
    s = np.empty_like(acc)
    low = np.empty(acc.shape, np.int64)
    acc32 = np.empty(acc.shape, np.float32)
    for d in range(p.shape[1]):
        np.multiply(a[:, d:d + 1], pt[d], out=prod)
        np.add(acc, prod, out=s)
        np.bitwise_and(s.view(np.int64), 0x1FFFFFFF, out=low)
        mid = low == 0x10000000
        if mid.any():
            sm, am, pm = s[mid], acc[mid], prod[mid]
            bb = sm - am
            err = (am - (sm - bb)) + (pm - bb)
            s[mid] = np.where(err == 0, sm,
                              np.nextafter(sm, np.copysign(np.inf, err)))
        acc32[...] = s
        acc[...] = acc32
    ldiff = np.abs(lens[r0:r1, None] - lens[None, :]).astype(np.float32)
    scores = acc32 - ldiff
    i = np.arange(r1 - r0)
    scores[i, i + r0] -= np.float32(1e9)
    return scores


def topn_scores_sequential_fma(profiles, lens, topn):
    """``isocon_tpu.graph.sketch._topn_scores`` with its dot as one
    in-order chain of exact float32 fmas per entry (numpy, row blocks on
    all cores): (values float32 [N, topn], indices int32 [N, topn]), in
    descending order, the lower index first on ties (``lax.top_k``)."""
    p32 = np.sqrt(np.asarray(profiles, dtype=np.float32))
    p = p32.astype(np.float64)
    pt = np.ascontiguousarray(p.T)
    lens = np.asarray(lens, dtype=np.int64)
    n = p.shape[0]
    vals = np.empty((n, topn), np.float32)
    idx = np.empty((n, topn), np.int32)

    def block(r0):
        r1 = min(n, r0 + BLOCK_ROWS)
        sc = _score_block(p, pt, lens, r0, r1)
        order = np.argsort(-sc, axis=1, kind="stable")[:, :topn]
        idx[r0:r1] = order
        vals[r0:r1] = np.take_along_axis(sc, order, axis=1)

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(block, range(0, n, BLOCK_ROWS)))
    return vals, idx


def run_pipeline(cli, native, reads, out, extra=()):
    """The JAX package's ``pipeline`` on ``reads`` into ``out``; returns
    the record: digests, engine volume at the phase boundary and at the
    end, HW survivors, the ED pairs of each call and the CPU seconds."""
    engines = []
    make_engine = cli.make_engine

    def recording_engine(params):
        engine = make_engine(params)
        engine.ed_call_pairs = []
        edit_distances = engine.edit_distances

        def counted(pairs, *args, **kw):
            engine.ed_call_pairs.append(len(pairs))
            return edit_distances(pairs, *args, **kw)

        engine.edit_distances = counted
        engines.append(engine)
        return engine

    # counters at the phase boundary: read where phase 2 is entered
    boundary = {}
    stat_filter_candidates = cli.stat_filter_candidates

    def at_boundary(read_file, candidate_file, read_partition, to_realign,
                    params, engine):
        boundary.update(engine.counters)
        boundary["seconds"] = time.perf_counter() - t0
        return stat_filter_candidates(read_file, candidate_file,
                                      read_partition, to_realign, params,
                                      engine)

    # survivors of the HW prefilter = the pairs the candidate graph hands
    # to the host traceback (its call has no k_cap; the engine's own native
    # HW path calls the same function with one, and is not counted)
    survivors = []
    hw_traceback_batch = native.hw_traceback_batch

    def counted_traceback(pairs, *args, **kw):
        if kw.get("k_cap") is None:
            survivors.append(len(pairs))
        return hw_traceback_batch(pairs, *args, **kw)

    cli.make_engine = recording_engine
    cli.stat_filter_candidates = at_boundary
    native.hw_traceback_batch = counted_traceback
    t0 = time.perf_counter()
    try:
        cli.main(["pipeline", "-fl_reads", reads, "-outfolder", out,
                  *extra])
    finally:
        cli.make_engine = make_engine
        cli.stat_filter_candidates = stat_filter_candidates
        native.hw_traceback_batch = hw_traceback_batch
    dt = time.perf_counter() - t0

    def digest(name):
        with open(os.path.join(out, name), "rb") as fh:
            data = fh.read()
        return hashlib.sha256(data).hexdigest(), data

    conv_sha, data = digest("candidates_converged.fa")
    final_sha, final = digest("final_candidates.fa")
    info_sha, _ = digest("cluster_info.tsv")
    (engine,) = engines
    c = engine.counters
    return {
        "candidates_converged_sha256": conv_sha,
        "final_candidates_sha256": final_sha,
        "cluster_info_sha256": info_sha,
        "n_candidates": data.count(b">"),
        "n_final_candidates": final.count(b">"),
        "ed_pairs": boundary["ed_pairs"], "ed_calls": boundary["ed_calls"],
        "align_pairs": boundary["align_pairs"],
        "align_calls": boundary["align_calls"],
        "end_ed_pairs": c["ed_pairs"], "end_ed_calls": c["ed_calls"],
        "end_align_pairs": c["align_pairs"],
        "end_align_calls": c["align_calls"],
        "hw_survivors": sum(survivors),
        "ed_call_pairs": engine.ed_call_pairs,
        "cpu_seconds_phase1": boundary["seconds"],
        "cpu_seconds": dt,
    }


def main() -> None:
    from chip_smoke import pin_hash_seed

    pin_hash_seed()     # cluster_info.tsv's row order depends on the seed
    flags = ("--long", "--nontargeted")
    args = [a for a in sys.argv[1:] if a not in flags]
    long_reads = "--long" in sys.argv[1:]
    nontargeted = "--nontargeted" in sys.argv[1:]
    n_reads = int(args[0])
    outdir = args[1]
    import isocon_tpu.native as native
    from isocon_tpu import cli
    from isocon_tpu_torch.workload import write_long_reads, write_reads

    os.makedirs(outdir, exist_ok=True)
    tag = "%s%d" % ("long_" if long_reads else
                    "nontargeted_" if nontargeted else "", n_reads)
    reads = os.path.join(outdir, "reads_%s.fa" % tag)
    if long_reads:
        write_long_reads(reads, n_reads)
    else:
        write_reads(reads, n_reads, families=4 if nontargeted else 1)
    out = os.path.join(outdir, "out_%s" % tag)
    if not nontargeted:
        print(json.dumps(dict({"n_reads": n_reads},
                              **run_pipeline(cli, native, reads, out))))
        return

    from isocon_tpu.graph import sketch

    unpinned = sketch._topn_scores
    calls = []

    def pinned(profiles, lens, topn):
        t1 = time.perf_counter()
        vals, idx = topn_scores_sequential_fma(profiles, lens, topn)
        secs = time.perf_counter() - t1
        _v, own = unpinned(profiles, lens, topn)
        own = np.asarray(own)
        calls.append({
            "rows": int(idx.shape[0]), "topn": int(topn),
            "rows_order_differ": int((own != idx).any(axis=1).sum()),
            "rows_set_differ": int((np.sort(own, axis=1)
                                    != np.sort(idx, axis=1)).any(axis=1)
                                   .sum()),
            "seconds": secs})
        return vals, idx

    sketch._topn_scores = pinned
    try:
        rec = run_pipeline(cli, native, reads, out, ["--nontargeted"])
    finally:
        sketch._topn_scores = unpinned
    free = run_pipeline(cli, native, reads, out + "_unpinned",
                        ["--nontargeted"])
    rec = dict({"n_reads": n_reads, "families": 4}, **rec)
    rec["sketch_calls"] = calls
    rec["unpinned"] = {k: free[k] for k in (
        "candidates_converged_sha256", "final_candidates_sha256",
        "cluster_info_sha256", "n_candidates", "n_final_candidates",
        "ed_pairs", "end_ed_pairs", "align_pairs", "end_align_pairs",
        "cpu_seconds")}
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
