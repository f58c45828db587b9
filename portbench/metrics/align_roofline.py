"""align_roofline: the least time the window's alignments need on the
card, over the device time of the alignment kernels (K3 and K4: names
with ``affine_``) in the traced window (the jobs' spans), in %.  The
least time is ``counts.bound_s`` of ``counts.align_work`` summed over
every alignment the jobs asked for, from its lengths and the alignment's
own columns alone."""

import numpy as np

from portbench import counts, trace

KERNELS = ("affine_",)


def read(run):
    if run.events is None or not run.clock_mhz:
        return None
    secs = trace.kernel_seconds(trace.within(run.events, run.trace_spans),
                                KERNELS)
    if secs <= 0:
        return None
    ops = nbytes = 0.0
    for la, lb, alns in run.recorder.align_calls:
        spans = np.array([counts.aligned_span(a1, a2)
                          for a1, a2, _c in alns], dtype=np.int64)
        if spans.size == 0:
            continue
        o, b = counts.align_work(la, lb, spans[:, 0], spans[:, 1])
        ops += o
        nbytes += b
    least, _by = counts.bound_s(nbytes, ops, run.clock_mhz)
    return 100.0 * least / secs
