"""phase2_s: phase 2 (stat_filter) seconds a job, from each job's
logfile line "TIME ELAPSED FOR STATISTICAL TEST OF CANDIDATES" (host
clock)."""


def read(run):
    vals = [j.phase_s[2] for j in run.jobs if 2 in j.phase_s]
    return sum(vals) / len(vals) if vals else None
