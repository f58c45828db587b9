"""stat_row_reuse_share: the share of phase 2's (read, edge) uses of a read
alignment that the statistical tests served from alignments already
converted to arrays, in %: 100 x (1 - stat_rows_built / stat_rows_used),
engine counters summed over the window's jobs at their ends; nothing where
the engine keeps no such counter or no test read an alignment."""


def read(run):
    if not run.jobs or "stat_rows_used" not in run.jobs[0].counters_end:
        return None
    used = sum(j.counters_end["stat_rows_used"] for j in run.jobs)
    if not used:
        return None
    built = sum(j.counters_end["stat_rows_built"] for j in run.jobs)
    return 100.0 * (1.0 - built / used)
