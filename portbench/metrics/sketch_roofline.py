"""sketch_roofline: the least time the window's sketch top-N lists need on
the card, over the device time of K6's kernels (names with ``sketch_``) in
the traced window (the jobs' spans), in %.  The least time is
``counts_sketch.bound_s`` of ``counts_sketch.sketch_work`` of the jobs'
engine counters ``sketch_score_cells`` (n(n - 1)/2 a call) and ``sketch_rows``
(n a call); nothing where the engine keeps no such counter or no such
kernel ran."""

from portbench import counts_sketch, trace

KERNELS = ("sketch_",)


def read(run):
    if run.events is None or not run.clock_mhz or not run.jobs:
        return None
    if any("sketch_score_cells" not in j.counters_end for j in run.jobs):
        return None
    secs = trace.kernel_seconds(trace.within(run.events, run.trace_spans),
                                KERNELS)
    if secs <= 0:
        return None
    ops, nbytes = counts_sketch.sketch_work(
        sum(j.counters_end["sketch_score_cells"] for j in run.jobs),
        sum(j.counters_end["sketch_rows"] for j in run.jobs))
    least, _by = counts_sketch.bound_s(nbytes, ops, run.clock_mhz)
    return 100.0 * least / secs
