"""frame_ms_p99: the 99th percentile over every frame of the window of the
time from handing the stereo pair to ``process_frame`` until the frame's
pose is on the host (VO cells: one frame per call)."""

import statistics


def read(run):
    if run.frames_per_call != 1 or len(run.latencies_s) < 100:
        return None
    return statistics.quantiles(run.latencies_s, n=100)[98] * 1e3
