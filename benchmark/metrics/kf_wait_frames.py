"""kf_wait_frames: the mean number of lockstep frames a rig's keyframe
request waits for its insert, the frame that serves it counted. Over the
window's lockstep frames, the sum of the requests waiting at each frame's
start (the program's counter ``kf_pending_n``, written by the batched
tracking body) over the sum of the inserts (``inserted_n``, written by
the advance body): Little's law, exact up to the requests still waiting
at the window's two ends."""

import numpy as np


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    S = run.frames_per_call
    first, stop = run.first_frame // S, (run.first_frame + run.frames) // S
    if rec is None or rec.frames_held(first, stop) == 0:
        return None
    try:
        waiting = rec.counter("kf_pending_n", first, stop)
        served = rec.counter("inserted_n", first, stop)
    except KeyError:     # a program without the lockstep counters
        return None
    both = np.isfinite(waiting) & np.isfinite(served)
    if served[both].sum() == 0:
        return None
    return float(waiting[both].sum() / served[both].sum())
