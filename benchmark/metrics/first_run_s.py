"""first_run_s: the seconds of the bodies' first eager runs, each to the
synchronize that opens its capture (the program's ``first_run.<body>``
set-up spans, summed); None where no window frame was recorded or no
body was captured."""


def read(run):
    from vslam_tpu_torch.utils import profiling

    rec = getattr(profiling, "latest_spans", lambda: None)()
    stop = run.first_frame + run.frames
    if rec is None or rec.frames_held(run.first_frame, stop) == 0:
        return None
    runs = [s for name, s in rec.setup_s().items()
            if name.startswith("first_run.")]
    return sum(runs) if runs else None
