"""k1_us_per_call: mean device time of ``landmark_top2_kernel`` (K1)
events in the traced stretch."""


def read(run):
    if run.trace is None:
        return None
    d = run.trace.kernel_us.get("landmark_top2_kernel") or []
    return sum(d) / len(d) if d else None
