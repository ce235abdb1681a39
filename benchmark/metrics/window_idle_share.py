"""window_idle_share: 1 - the union of the card's body spans (bodies T, A
and K, mapped onto the host clock) over the wall time from the window's
first ``frame`` span's start to its last one's end (the program's spans,
untraced frames)."""


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    stop = run.first_frame + run.frames
    if rec is None or rec.frames_held(run.first_frame, stop) == 0:
        return None
    idle = rec.idle(run.first_frame, stop)
    return idle["idle_share"] if idle else None
