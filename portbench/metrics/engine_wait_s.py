"""engine_wait_s: seconds a job in the engine's collects, the host clock
around each batch's fetch and its wait for the card (the engine counters
ed_wait_seconds + align_wait_seconds at the job's end); nothing where the
engine keeps no such counters."""

KEYS = ("ed_wait_seconds", "align_wait_seconds")


def read(run):
    if not run.jobs or any(k not in run.jobs[0].counters_end for k in KEYS):
        return None
    return (sum(j.counters_end[k] for j in run.jobs for k in KEYS)
            / len(run.jobs))
