"""window_ba_device_ms: the median over the window's keyframes of body K's
window BA: its build, solve and merge stages (``keyframe.ba_build`` +
``keyframe.ba_solve`` + ``keyframe.ba_merge``) in the program's spans."""

import numpy as np


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    stop = run.first_frame + run.frames
    if rec is None or rec.frames_held(run.first_frame, stop) == 0:
        return None
    d = sum(rec.durations_ms("keyframe." + stage, run.first_frame, stop)
            for stage in ("ba_build", "ba_solve", "ba_merge"))
    d = d[np.isfinite(d)]
    return float(np.median(d)) if len(d) else None
