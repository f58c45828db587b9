"""wave_rerun_share: the share of the banded wavefront's pair runs (K5)
that ran a pair again at a doubled band after its answer failed to
certify, in %: the engine counters wave_pairs_rerun over
ed_pairs_wavefront, summed over the window's jobs at their ends; nothing
where the engine keeps no such counter or K5 ran no pair."""


def read(run):
    if not run.jobs or "wave_pairs_rerun" not in run.jobs[0].counters_end:
        return None
    runs = sum(j.counters_end["ed_pairs_wavefront"] for j in run.jobs)
    if not runs:
        return None
    return (100.0 * sum(j.counters_end["wave_pairs_rerun"] for j in run.jobs)
            / runs)
