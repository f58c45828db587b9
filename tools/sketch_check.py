#!/usr/bin/env python3
"""Hold the sketch retrieval of ``--nontargeted`` to its plain float64
reference (``portbench/sketch_reference.py``) under the traffic of
``nontargeted_pipeline``, the only benchmark cell through the sketch, on
the card.

    python3 tools/sketch_check.py --seeds N [N ...] [--out FILE]

For each seed, job 0 of the cell (``portbench/generator.make_job``) runs
through the port's CLI (``pipeline`` with the traffic's arguments), with a
wrapper round ``graph/sketch.py::approximate_nn_graph`` that keeps each
sketch call's sequences, converged mask, the candidate lists with their
scores (``ops/sketch.py::topn_scores``, which the main path's
``topn_indices`` reads the indices of: the lists are the same) and the
engine's exact distances of the rescoring pairs.  Then every row of the
first call (the first NN round) and a seeded sample of 4,096 rows of
each later call are checked on the card:

* profiles: the port's ``kmer_profile`` rows equal the reference's
  exactly, and their float32 square roots are the ones K6 read;
* lists: each is a valid top 20 under the reference's scores
  (``check_rows``: within 2 beta of the 20th best), and each returned
  score lies within its pair's beta of the float64 score;
* distances: the engine's distance of each of those rows' rescoring pairs
  equals the reference DP's (``reference.edit_distances``, NW).

One JSON line a call to standard output, a summary line last, and all of
it to ``--out`` where given.  The job's own outputs are not compared
here: the cell's ``correct`` does that.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORKLOAD = "nontargeted_pipeline"
SAMPLE = 4096                   # rows checked of each call after the first
DEVICE = "cuda"


class Capture:
    """The wrapper round ``approximate_nn_graph``: one record a call."""

    def __init__(self):
        self.calls = []

    def install(self):
        import numpy as np

        from isocon_tpu_torch.graph import sketch
        from isocon_tpu_torch.ops import sketch as ops_sketch

        orig_graph = sketch.approximate_nn_graph
        orig_topn = sketch.topn_indices
        cap = self

        def topn_indices(prof_sqrt, lens, k, *args, **kwargs):
            vals, idx = ops_sketch.topn_scores(prof_sqrt, lens, k)
            rec = cap.calls[-1]
            rec["roots"] = prof_sqrt.cpu()
            rec["vals"] = vals.cpu().numpy()
            rec["idx"] = idx.cpu().numpy()
            return idx

        def approximate_nn_graph(unique_seqs, converged, engine, *args,
                                 **kwargs):
            rec = {"seqs": list(unique_seqs), "converged": list(converged)}
            cap.calls.append(rec)
            orig_idx = engine.edit_distances_idx

            def edit_distances_idx(ia, ib, *a, **kw):
                ed, ej = orig_idx(ia, ib, *a, **kw)
                rec["eds"] = np.asarray(ed, dtype=np.int64).copy()
                return ed, ej

            engine.edit_distances_idx = edit_distances_idx
            try:
                return orig_graph(unique_seqs, converged, engine, *args,
                                  **kwargs)
            finally:
                del engine.edit_distances_idx

        sketch.topn_indices = topn_indices
        sketch.approximate_nn_graph = approximate_nn_graph

        def restore():
            sketch.topn_indices = orig_topn
            sketch.approximate_nn_graph = orig_graph
        return restore


def run_job(cell, seed, workdir):
    """Job 0 of ``seed`` through the CLI; returns its seconds and reads."""
    import torch

    from isocon_tpu_torch import cli
    from portbench.generator import make_job, write_fasta

    _iso, reads = make_job(cell.config, seed, 0)
    fasta = os.path.join(workdir, "reads.fa")
    write_fasta(fasta, reads)
    argv = ([cell.traffic["subcommand"], "-fl_reads", fasta, "-outfolder",
             os.path.join(workdir, "out"), "--device", DEVICE]
            + list(cell.traffic.get("args", [])))
    t0 = time.perf_counter()
    runner, params = cli.parse(argv)
    try:
        runner(params)
        torch.cuda.synchronize()
    finally:
        if params.logfile is not None:
            params.logfile.close()
    return time.perf_counter() - t0, len(reads)


def check_call(rec, rows):
    """The checks of one sketch call on ``rows``."""
    import numpy as np
    import torch

    from isocon_tpu_torch.graph.sketch import kmer_profile
    from portbench import sketch_reference as ref

    seqs = rec["seqs"]
    n = len(seqs)
    lens = [len(s) for s in seqs]
    t0 = time.perf_counter()
    prof = ref.profiles(seqs, DEVICE)
    mine = np.stack([kmer_profile(seqs[r]) for r in rows])
    prof_differ = int((torch.from_numpy(mine.astype(np.float64)).to(DEVICE)
                       != prof[torch.as_tensor(rows, device=DEVICE)])
                      .any(dim=1).sum())
    roots_differ = int((torch.from_numpy(np.sqrt(mine))
                        != rec["roots"][torch.as_tensor(rows)])
                       .any(dim=1).sum())
    lists = ref.check_rows(prof, lens, rows, rec["idx"][rows],
                           rec["vals"][rows])
    # the rescoring pairs of those rows: the graph's keys, in its order
    keys = [(i, int(j)) for i in range(n) if not rec["converged"][i]
            for j in rec["idx"][i]]
    want_rows = set(int(r) for r in rows)
    sel = [k for k, (i, _j) in enumerate(keys) if i in want_rows]
    pairs = [(seqs[keys[k][0]], seqs[keys[k][1]]) for k in sel]
    ref_d = ref.nw_distances(pairs, torch.device(DEVICE))
    got_d = rec["eds"][sel]
    return {"n": n, "rows": len(rows), "profiles_differ": prof_differ,
            "roots_differ": roots_differ,
            "lists_invalid": lists["lists_invalid"],
            "scores_outside": lists["scores_outside"],
            "worst_score_ratio": lists["worst_score_ratio"],
            "pairs": len(sel),
            "distances_wrong": int((ref_d != got_d).sum()),
            "check_s": time.perf_counter() - t0}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0")
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    import numpy as np

    from portbench.spec import load_cell

    cell = load_cell(WORKLOAD)
    lines = []
    total = {"calls": 0, "rows": 0, "pairs": 0, "profiles_differ": 0,
             "roots_differ": 0, "lists_invalid": 0, "scores_outside": 0,
             "distances_wrong": 0, "worst_score_ratio": 0.0}
    for seed in args.seeds:
        cap = Capture()
        restore = cap.install()
        workdir = tempfile.mkdtemp(prefix="sketch_check_")
        try:
            secs, nreads = run_job(cell, seed, workdir)
        finally:
            restore()
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"seed": seed, "job_s": secs, "reads": nreads,
                          "sketch_calls": len(cap.calls)}), flush=True)
        for r, rec in enumerate(cap.calls):
            n = len(rec["seqs"])
            if n <= 1 or "idx" not in rec:
                continue
            if r == 0 or n <= SAMPLE:
                rows = np.arange(n)
            else:
                rng = np.random.default_rng([seed % 2 ** 64, r])
                rows = np.sort(rng.choice(n, SAMPLE, replace=False))
            out = dict(seed=seed, call=r, **check_call(rec, rows))
            lines.append(out)
            print(json.dumps(out), flush=True)
            total["calls"] += 1
            for key in ("rows", "pairs", "profiles_differ", "roots_differ",
                        "lists_invalid", "scores_outside",
                        "distances_wrong"):
                total[key] += out[key]
            total["worst_score_ratio"] = max(total["worst_score_ratio"],
                                             out["worst_score_ratio"])
    total["ok"] = not any(total[k] for k in (
        "profiles_differ", "roots_differ", "lists_invalid", "scores_outside",
        "distances_wrong"))
    lines.append(total)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("".join(json.dumps(x) + "\n" for x in lines))
    print(json.dumps(total), flush=True)
    return 0 if total["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
