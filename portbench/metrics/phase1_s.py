"""phase1_s: phase 1 (get_candidates) seconds a job, from each job's
logfile line "TIME ELAPSED FOR FINDING CANDIDATES" (host clock)."""


def read(run):
    vals = [j.phase_s[1] for j in run.jobs if 1 in j.phase_s]
    return sum(vals) / len(vals) if vals else None
