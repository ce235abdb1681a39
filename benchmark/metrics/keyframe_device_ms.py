"""keyframe_device_ms: the median over the window's keyframes of body K's
device span, from its first stage stamp to its last (the program's
spans)."""

import numpy as np


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    stop = run.first_frame + run.frames
    if rec is None or rec.frames_held(run.first_frame, stop) == 0:
        return None
    d = rec.durations_ms("device.keyframe", run.first_frame, stop)
    d = d[np.isfinite(d)]
    return float(np.median(d)) if len(d) else None
