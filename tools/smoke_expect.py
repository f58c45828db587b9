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

Usage: JAX_PLATFORMS=cpu python tools/smoke_expect.py [--long] N_READS OUTDIR
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from chip_smoke import pin_hash_seed

    pin_hash_seed()     # cluster_info.tsv's row order depends on the seed
    args = [a for a in sys.argv[1:] if a != "--long"]
    long_reads = "--long" in sys.argv[1:]
    n_reads = int(args[0])
    outdir = args[1]
    import isocon_tpu.native as native
    from isocon_tpu import cli
    from isocon_tpu_torch.workload import write_long_reads, write_reads

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

    cli.make_engine = recording_engine

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

    cli.stat_filter_candidates = at_boundary

    # survivors of the HW prefilter = the pairs the candidate graph hands
    # to the host traceback (its call has no k_cap; the engine's own native
    # HW path calls the same function with one, and is not counted)
    survivors = []
    hw_traceback_batch = native.hw_traceback_batch

    def counted_traceback(pairs, *args, **kw):
        if kw.get("k_cap") is None:
            survivors.append(len(pairs))
        return hw_traceback_batch(pairs, *args, **kw)

    native.hw_traceback_batch = counted_traceback
    os.makedirs(outdir, exist_ok=True)
    tag = "%s%d" % ("long_" if long_reads else "", n_reads)
    reads = os.path.join(outdir, "reads_%s.fa" % tag)
    (write_long_reads if long_reads else write_reads)(reads, n_reads)
    out = os.path.join(outdir, "out_%s" % tag)
    t0 = time.perf_counter()
    cli.main(["pipeline", "-fl_reads", reads, "-outfolder", out])
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
    print(json.dumps({
        "n_reads": n_reads,
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
    }))


if __name__ == "__main__":
    main()
