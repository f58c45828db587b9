"""The ``correct`` comparison: what the window's jobs produced, against
the plain reference (``reference.py``) and the generator's truth.

Numbers compared, each against its limit in ``checks/<cell>.json``:

* ``ed_nw_wrong``, ``ed_hw_wrong``: sampled edit distances (the
  recorder's reservoirs over every pair the jobs computed) whose answer
  is not the reference's: the exact distance where it is within the
  caller's cap, else -1; for HW also the span's end, which must be a
  column where the query's last DP row holds the distance;
* ``align_wrong``: sampled alignments that are not an alignment of their
  two sequences, or score below the reference's optimum, or whose
  (matches, mismatches, indels) are not the alignment's own;
* ``cluster_errors``: rows of a job's ``cluster_info.tsv`` that name a
  read not in the job or a candidate not in ``final_candidates.fa``,
  give a wrong length, or repeat a read, and reads of the job that it
  does not name (phase 2 assigns every read to a final candidate);
* ``jobs_failed``: jobs that raised;
* ``isoforms_missed``: the generator's isoforms that a job's
  ``final_candidates.fa`` does not hold exactly, summed over the window's
  jobs;
* ``candidates_extra``: a job's final candidates that are no isoform of
  its family, summed over the window's jobs.

The first five are exact comparisons, with the limit 0.  The last two
hold the outputs against the generator's truth, which IsoCon's method
recovers nearly always but is not bound to: their limits lie between
what sound runs and a planted fault read (see PERF.md).
"""
from __future__ import annotations

from typing import Dict, List

from . import reference


def read_fasta(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    acc = None
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                acc = line[1:]
                out[acc] = ""
            elif acc is not None:
                out[acc] += line
    return out


def job_outputs(final_fa: str, cluster_tsv: str, reads: List[str],
                isoforms: List[str]) -> Dict[str, int]:
    """The output numbers of one job (see the module's list)."""
    finals = read_fasta(final_fa)
    lens = {"read_%d" % i: len(s) for i, s in enumerate(reads)}
    errors = 0
    seen = set()
    with open(cluster_tsv) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh]
    # a final header is <candidate>_<support>_<p-value>_<N_t>_<delta>, and
    # the p-value may hold an underscore ("not_tested")
    by_acc = {}
    for c in {f[1] for f in rows if len(f) == 4}:
        hit = [h for h in finals if h.startswith(c + "_")]
        if len(hit) == 1:
            by_acc[c] = finals[hit[0]]
    for f in rows:
        if (len(f) != 4 or f[0] not in lens or f[0] in seen
                or f[1] not in by_acc or int(f[2]) != lens[f[0]]
                or int(f[3]) != len(by_acc[f[1]])):
            errors += 1
        seen.add(f[0])
    truth = set(isoforms)
    got = set(finals.values())
    return {"cluster_errors": errors + len(set(lens) - seen),
            "isoforms_missed": len(truth - got),
            "candidates_extra": len(got - truth)}


def judge_ed(sample: List[tuple], hw: bool, device) -> int:
    """Sampled (a, b, cap, answer, end) whose answer is wrong."""
    if not sample:
        return 0
    pairs = [(a, b) for a, b, _c, _d, _e in sample]
    dist, rows = reference.edit_distances(pairs, hw, device)
    wrong = 0
    for k, (a, b, cap, ans, end) in enumerate(sample):
        want = int(dist[k]) if dist[k] <= cap else -1
        if ans != want:
            wrong += 1
        elif hw and ans >= 0 and not (
                0 <= end <= len(b) and int(rows[k][end]) == ans):
            wrong += 1
    return wrong


def judge_align(sample: List[tuple], device) -> int:
    """Sampled (a, b, score, (a1, a2, counts)) that are wrong."""
    if not sample:
        return 0
    pairs = [(a, b) for a, b, _s, _r in sample]
    best = reference.semi_global_scores(pairs, [s for _a, _b, s, _r in sample],
                                        device)
    wrong = 0
    for k, (a, b, score, res) in enumerate(sample):
        a1, a2, counts = res
        got = reference.alignment_score(a1, a2, a, b, score)
        if (got is None or got[0] != int(best[k])
                or tuple(int(x) for x in counts) != got[1]):
            wrong += 1
    return wrong


def numbers(samples: dict, outputs: List[Dict[str, int]], failed: int,
            device) -> Dict[str, int]:
    """Every number compared, from the recorder's samples and the jobs'
    output numbers."""
    out = {
        "ed_nw_wrong": judge_ed(samples["ed_nw"].items, False, device),
        "ed_hw_wrong": judge_ed(samples["ed_hw"].items, True, device),
        "align_wrong": judge_align(samples["align"].items, device),
        "jobs_failed": failed,
    }
    for k in ("cluster_errors", "isoforms_missed", "candidates_extra"):
        out[k] = int(sum(o[k] for o in outputs))
    return out


def verdict(nums: Dict[str, int], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]): correct when every number is
    at most its limit; a number without a limit fails."""
    rows = [(k, nums[k], limits.get(k)) for k in nums]
    ok = all(lim is not None and v <= lim for _k, v, lim in rows)
    return ok, rows

