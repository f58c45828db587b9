"""device_idle_share: the share of the traced window (the jobs' own
spans) in which the card ran no kernel, copy or fill (1 - the union of
their intervals over the window, ``trace.busy_seconds``), in %."""


def read(run):
    if run.busy_s is None or run.trace_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace_s)
