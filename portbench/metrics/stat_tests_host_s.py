"""stat_tests_host_s: seconds a job of phase 2's statistical tests (stats/)
on the host: the self time of the program's span
``isocon_phase2.tests``, its duration less the engine's calls nested in
it (``spans.per_job``); nothing where the program records no such span."""

from portbench import spans


def read(run):
    return spans.per_job(run, "isocon_phase2.tests")
