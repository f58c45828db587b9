"""align_decode_s: seconds a job in the engine's decode of the alignment
batches' opcodes into alignments (the engine counter align_decode_seconds
at the job's end, the host clock around each batch's decode loop); nothing
where the engine keeps no such counter."""


def read(run):
    if not run.jobs or "align_decode_seconds" not in run.jobs[0].counters_end:
        return None
    return (sum(j.counters_end["align_decode_seconds"] for j in run.jobs)
            / len(run.jobs))
