"""engine_host_s: seconds a job inside the engine's calls on the host,
apart from its waits and its alignment decode: ed_seconds + align_seconds
less ed_wait_seconds, align_wait_seconds and align_decode_seconds (engine
counters at the job's end): interning, pool uploads, batching and
certification.  With engine_wait_s and align_decode_s it sums to engine_s.
Nothing where the engine keeps no such counters."""

PARTS = ("ed_wait_seconds", "align_wait_seconds", "align_decode_seconds")


def read(run):
    if not run.jobs or any(k not in run.jobs[0].counters_end for k in PARTS):
        return None
    return sum(j.counters_end["ed_seconds"] + j.counters_end["align_seconds"]
               - sum(j.counters_end[k] for k in PARTS)
               for j in run.jobs) / len(run.jobs)
