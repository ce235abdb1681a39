"""graph_capture_s: the seconds the driver spent capturing its CUDA graphs
(``capture_stats``, summed)."""


def read(run):
    if not run.capture_stats:
        return None
    return sum(s["seconds"] for s in run.capture_stats.values())
