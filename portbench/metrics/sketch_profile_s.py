"""sketch_profile_s: seconds a job in the host's hashed k-mer profiles of
the sketch (graph/sketch.py::kmer_profile, one a row of each sketch call):
the engine counter sketch_profile_seconds at the job's end, a part of
sketch_s; nothing where the engine keeps no such counter."""


def read(run):
    if not run.jobs or any("sketch_profile_seconds" not in j.counters_end
                           for j in run.jobs):
        return None
    return (sum(j.counters_end["sketch_profile_seconds"] for j in run.jobs)
            / len(run.jobs))
