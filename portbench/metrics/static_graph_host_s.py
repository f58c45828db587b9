"""static_graph_host_s: seconds a job of phase 2's ends-ignored candidate
graph (graph/end_invariant.py, its host C++ traceback included) on the
host: the self time of the program's span
``isocon_phase2.static_graph``, its duration less the engine's calls
nested in it (``spans.per_job``); nothing where the program records no
such span."""

from portbench import spans


def read(run):
    return spans.per_job(run, "isocon_phase2.static_graph")
