"""upload_mib: MiB a job the engine sent to the card through
``parallel.sharding.upload``: pool rows and lengths, index and score
vectors (the engine counter upload_bytes at the job's end); nothing where
the engine keeps no such counter."""


def read(run):
    if not run.jobs or "upload_bytes" not in run.jobs[0].counters_end:
        return None
    return (sum(j.counters_end["upload_bytes"] for j in run.jobs)
            / len(run.jobs) / 2 ** 20)
