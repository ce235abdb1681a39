"""host_busy_ms_per_frame: the median over the window's frames of the
host's time in ``process_frame`` (its ``frame`` span) less its wait for
the keyframe decision (its ``read`` span), in the program's spans."""

import numpy as np


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    stop = run.first_frame + run.frames
    if rec is None or rec.frames_held(run.first_frame, stop) == 0:
        return None
    d = (rec.durations_ms("frame", run.first_frame, stop)
         - rec.durations_ms("read", run.first_frame, stop))
    d = d[np.isfinite(d)]
    return float(np.median(d)) if len(d) else None
