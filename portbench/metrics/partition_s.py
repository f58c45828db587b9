"""partition_s: seconds a job of phase 1's star partition
(graph/partition.py and the dicts built from it) on the host: the self
time of the program's span ``isocon_phase1.partition``, its duration
less the engine's calls nested in it (``spans.per_job``); nothing where
the program records no such span."""

from portbench import spans


def read(run):
    return spans.per_job(run, "isocon_phase1.partition")
