"""phase1_host_s: phase 1's seconds a job outside the engine's calls:
phase1_s less the engine's ed_seconds + align_seconds at phase 1's end
(the counters ``run_pipeline`` returns).  The host's graph and
correction layers (graph/, correct/, pipeline/alignments.py,
alnutils.py)."""


def read(run):
    vals = [j.phase_s[1] - j.counters_phase1["ed_seconds"]
            - j.counters_phase1["align_seconds"]
            for j in run.jobs
            if 1 in j.phase_s and j.counters_phase1 is not None]
    return sum(vals) / len(vals) if vals else None
