"""launch_idle_ms_per_frame: the card's idle time (the gaps between its
bodies' device spans, mapped onto the host clock) that falls inside the
host's ``launch.*`` spans over the window, per window frame (the
program's spans, ``SpanRecorder.idle``)."""


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    stop = run.first_frame + run.frames
    if rec is None or rec.frames_held(run.first_frame, stop) == 0:
        return None
    idle = rec.idle(run.first_frame, stop)
    return idle["launch_ms"] / idle["frames"] if idle else None
