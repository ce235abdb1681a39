"""host_calls_per_frame: CUDA runtime launch, graph-launch, copy and
memset calls per frame in the traced stretch."""


def read(run):
    if run.trace is None or run.trace.frames == 0:
        return None
    return run.trace.host_launch_calls / run.trace.frames
