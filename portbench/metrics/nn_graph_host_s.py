"""nn_graph_host_s: seconds a job of phase 1's NN graph (graph/nn.py;
graph/sketch.py under --nontargeted) on the host: the self time of the
program's span ``isocon_phase1.nn_graph``, its duration less the
engine's calls nested in it (``spans.per_job``); nothing where the
program records no such span."""

from portbench import spans


def read(run):
    return spans.per_job(run, "isocon_phase1.nn_graph")
