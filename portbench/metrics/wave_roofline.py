"""wave_roofline: the least time the window's long edit distances need on
the card, over the device time of the banded wavefront kernel (K5: names
with ``wavefront_``) in the traced window (the jobs' spans), in %.  A
long distance is one whose longer sequence exceeds 16,384 bases, so that
its pool is wider than the Myers kernels take and K5 runs it; its least
time is ``counts.bound_s`` of ``counts.ed_work`` (the yardstick of
``ed_roofline``), summed over every such pair the jobs asked for (NW and
HW), from its lengths, cap and answer alone.  Nothing where no such
kernel ran."""

import numpy as np

from portbench import counts, trace

KERNELS = ("wavefront_",)
LONG_BASES = 16384


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
            long_ = np.maximum(la, lb) > LONG_BASES
            o, b = counts.ed_work(la[long_], lb[long_], ans[long_],
                                  caps[long_], hw=route == "ed_hw")
            ops += o
            nbytes += b
    least, _by = counts.bound_s(nbytes, ops, run.clock_mhz)
    return 100.0 * least / secs
