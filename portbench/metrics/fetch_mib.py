"""fetch_mib: MiB a job of results the engine read back from the card, the
bytes of the host arrays its collects returned (the engine counter
fetch_bytes at the job's end); nothing where the engine keeps no such
counter."""


def read(run):
    if not run.jobs or "fetch_bytes" not in run.jobs[0].counters_end:
        return None
    return (sum(j.counters_end["fetch_bytes"] for j in run.jobs)
            / len(run.jobs) / 2 ** 20)
