"""ed_roofline: the least time the window's edit distances need on the
card, over the device time of the edit-distance kernels (K1, K2: names
with ``myers_``; K5: ``wavefront_``) in the traced window (the jobs'
spans), in %.  The least time is ``counts.bound_s`` of ``counts.ed_work``
summed over every pair the jobs asked for (NW and HW), from its lengths,
cap and answer alone."""

from portbench import counts, trace

KERNELS = ("myers_", "wavefront_")


def read(run):
    if run.events is None or not run.clock_mhz:
        return None
    secs = trace.kernel_seconds(trace.within(run.events, run.trace_spans),
                                KERNELS)
    if secs <= 0:
        return None
    ops = nbytes = 0.0
    for route, calls in run.recorder.ed_calls.items():
        for la, lb, caps, ans in calls:
            o, b = counts.ed_work(la, lb, ans, caps, hw=route == "ed_hw")
            ops += o
            nbytes += b
    least, _by = counts.bound_s(nbytes, ops, run.clock_mhz)
    return 100.0 * least / secs
