"""wave_wait_s: seconds a job in the collects of the banded wavefront's
batches (K5), the host clock around each one's fetch and its wait for the
card (the engine counter wave_wait_seconds at the job's end, a part of
ed_wait_seconds); nothing where the engine keeps no such counter."""


def read(run):
    if not run.jobs or "wave_wait_seconds" not in run.jobs[0].counters_end:
        return None
    return (sum(j.counters_end["wave_wait_seconds"] for j in run.jobs)
            / len(run.jobs))
