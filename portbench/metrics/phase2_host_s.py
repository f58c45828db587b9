"""phase2_host_s: phase 2's seconds a job outside the engine's calls and
the host traceback: phase2_s less phase 2's ed_seconds + align_seconds
and hw_traceback_seconds (the engine's counters at the job's end less
those at phase 1's end).  The host statistics layer (stats/,
pipeline/stat_filter.py)."""

KEYS = ("ed_seconds", "align_seconds", "hw_traceback_seconds")


def read(run):
    vals = []
    for j in run.jobs:
        if 2 not in j.phase_s or j.counters_phase1 is None:
            continue
        spent = sum(j.counters_end[k] - j.counters_phase1[k] for k in KEYS)
        vals.append(j.phase_s[2] - spent)
    return sum(vals) / len(vals) if vals else None
