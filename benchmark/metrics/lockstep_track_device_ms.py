"""lockstep_track_device_ms: the median over the window's lockstep frames
of the batched tracking body's device span (``device.lockstep_track``,
from its first stage stamp to its last; the program's spans)."""

import numpy as np


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    S = run.frames_per_call
    first, stop = run.first_frame // S, (run.first_frame + run.frames) // S
    if rec is None or rec.frames_held(first, stop) == 0:
        return None
    try:
        d = rec.durations_ms("device.lockstep_track", first, stop)
    except KeyError:     # a program without the lockstep bodies' spans
        return None
    d = d[np.isfinite(d)]
    return float(np.median(d)) if len(d) else None
