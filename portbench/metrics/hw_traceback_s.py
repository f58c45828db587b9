"""hw_traceback_s: seconds a job in the host C++ traceback of phase 2's
candidate graph (the engine counter hw_traceback_seconds; native/)."""


def read(run):
    if not run.jobs:
        return None
    return (sum(j.counters_end["hw_traceback_seconds"] for j in run.jobs)
            / len(run.jobs))
