"""sketch_s: seconds a job of the sketch retrieval of ``--nontargeted``
(graph/sketch.py: the k-mer profiles, their upload, K6's two launches and
the lists' fetch): the self time of the program's span
``isocon_phase1.sketch``, a part of ``isocon_phase1.nn_graph``
(``spans.per_job``); nothing where the program records no such span."""

from portbench import spans


def read(run):
    return spans.per_job(run, "isocon_phase1.sketch")
