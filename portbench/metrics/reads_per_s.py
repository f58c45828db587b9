"""reads_per_s: every read of every job the window ran, over the window's
clock (host): the sum of the jobs' wall times, each from the command
line's parse to its outputs written and the card finished.  Making a
job's reads and reading and removing its outputs, the benchmark's own
work, lie outside it.  Jobs that raised count no reads; their time
counts."""


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return sum(j.reads for j in run.jobs) / run.window_s
