"""track_device_ms: the median over the window's frames that made no
keyframe of body T's device span, from its first stage stamp to its last
(the program's spans, ``profiling.latest_spans()``)."""

import numpy as np


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    stop = run.first_frame + run.frames
    if rec is None or rec.frames_held(run.first_frame, stop) == 0:
        return None
    d = rec.durations_ms("device.track", run.first_frame, stop)
    d = d[~np.asarray(run.is_keyframe[:len(d)], bool)]
    d = d[np.isfinite(d)]
    return float(np.median(d)) if len(d) else None
