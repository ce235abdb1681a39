"""keyframe_ms: the median latency of the window's keyframe frames (VO
cells: one frame per call)."""

import statistics


def read(run):
    if run.frames_per_call != 1:
        return None
    lat = [t for t, kf in zip(run.latencies_s, run.is_keyframe) if kf]
    return statistics.median(lat) * 1e3 if lat else None
