"""k2_us_per_call: mean device time of ``hamming_top2_kernel`` (K2)
events in the traced stretch."""


def read(run):
    if run.trace is None:
        return None
    d = run.trace.kernel_us.get("hamming_top2_kernel") or []
    return sum(d) / len(d) if d else None
