"""Tracing / profiling hooks.

Port of ``vslam_tpu/utils/profiling.py`` onto ``torch.profiler``: a trace
capture (a Chrome trace, viewable in Perfetto or chrome://tracing) plus
the wall-clock stage timers of ``utils/metrics.StageTimer``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (no-op when None): host activity, and the
    card's when one is present.

    Usage:
        with profiling.trace("traces"):
            slam.process_frame(...)
    """
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range for host-side stages (shows up in the trace)."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` per card ({} without one)."""
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
