"""Tracing / profiling hooks.

Port of ``vslam_tpu/utils/profiling.py`` onto ``torch.profiler``: a trace
capture (a Chrome trace, viewable in Perfetto or chrome://tracing) plus
the wall-clock stage timers of ``utils/metrics.StageTimer``; and the two
timings the measurement tools and ``chip_smoke.py`` take of one call:
``wall_ms`` (blocking) and ``device_ms`` (a profiler window).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
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


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, n: int = 20, device="cuda") -> float:
    """Median of ``n`` blocking calls of ``fn`` in ms, each ended by a
    synchronize, after one untimed call."""
    fn()
    sync(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, only: str = "", iters: int = 20, windows: int = 3,
              device="cuda"):
    """Device time per call of ``fn`` from a ``torch.profiler`` window:
    (ms of every kernel and copy it launches, ms of the kernels whose name
    contains ``only``, device operations per call, device events seen).
    On the CPU the device is the CPU: the ms are the operators' self CPU
    time and the operations are operator calls.

    The profiler may drop an odd event of the window (19 of 20 launches
    of one kernel have been seen), so each device operation is counted
    per call as ceil(its events / calls), at least one for any operation
    seen at all, and timed as its mean event time that many times. It
    has also handed over a window with no device event at all (late in
    a long run), so an empty window is taken again, up to ``windows``
    times; after that the time per call is taken from CUDA events (on the
    CPU, the host clock) around ``iters`` calls back to back (an upper
    bound: the host's launch gaps count where they exceed the kernel; said
    so in the output), with the device operations unknown (None)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])

    def self_us(evt):
        return evt.self_device_time_total if cuda else evt.self_cpu_time_total

    fn()
    sync(device)
    for _ in range(windows):
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            sync(device)
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == kind and evt.count > 0]
        if (sum(self_us(evt) for evt in events) > 0
                and any(only in evt.key for evt in events)):
            break
        print(f"the profiler saw no device time for {only or 'the call'} "
              f"in a window of {iters} calls", flush=True)
    else:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        print(f"device time of {only or 'the call'} from "
              f"{'CUDA events' if cuda else 'the host clock'} around "
              f"{iters} calls: {ms:.4f} ms per call", flush=True)
        return ms, ms, None, 0
    per_call = {evt.key: -(-evt.count // iters) for evt in events}
    us = {evt.key: self_us(evt) / evt.count * per_call[evt.key]
          for evt in events}
    return (sum(us.values()) / 1e3,
            sum(t for key, t in us.items() if only in key) / 1e3,
            sum(per_call.values()), sum(evt.count for evt in events))
