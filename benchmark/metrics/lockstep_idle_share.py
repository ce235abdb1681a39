"""lockstep_idle_share: 1 - the union of the card's lockstep body spans
(tracking, insert, window BA, advance; mapped onto the host clock) over
the wall time from the window's first lockstep ``frame`` span's start to
its last one's end (the program's spans, untraced frames)."""


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    S = run.frames_per_call
    first, stop = run.first_frame // S, (run.first_frame + run.frames) // S
    if rec is None or rec.frames_held(first, stop) == 0:
        return None
    idle = rec.idle(first, stop)
    return idle["idle_share"] if idle else None
