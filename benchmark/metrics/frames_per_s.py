"""frames_per_s: frames completed in the window over all of its time."""


def read(run):
    return run.frames / run.window_s
