"""engine_s: seconds a job inside the engine's calls, the host clock
around them including their waits on the card (the engine counters
ed_seconds + align_seconds at the job's end)."""


def read(run):
    if not run.jobs:
        return None
    return (sum(j.counters_end["ed_seconds"] + j.counters_end["align_seconds"]
                for j in run.jobs) / len(run.jobs))
