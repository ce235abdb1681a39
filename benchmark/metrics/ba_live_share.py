"""ba_live_share: the window BA's LM bodies that did work
(``solve_ba_schur``'s iterations, counter ``lm_live``) over the bodies
run (``lm_run``), summed over the window's keyframes (the program's
counters)."""

import numpy as np


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    stop = run.first_frame + run.frames
    if rec is None or rec.frames_held(run.first_frame, stop) == 0:
        return None
    live = np.nansum(rec.counter("lm_live", run.first_frame, stop))
    ran = np.nansum(rec.counter("lm_run", run.first_frame, stop))
    return float(live / ran) if ran > 0 else None
