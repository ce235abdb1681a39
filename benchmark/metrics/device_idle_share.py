"""device_idle_share: 1 - device busy time (the union of the traced
operations' intervals) over the traced stretch's wall time. The profiler
slows the host, so this is an upper bound of the untraced run's share."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return max(0.0, 1.0 - run.trace.busy_s / run.trace.window_s)
