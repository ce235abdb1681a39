"""The traced window: ``torch.profiler`` over a few steps of the cell.

The arithmetic of ``chip_smoke.graph_window``: host CUDA runtime calls
(launches, copies, memsets) per frame, device busy time over the window's
wall time, the Hamming kernels' events. Added here: busy time as the
union of kernel intervals, the device operations that took most time,
and the idle gaps labelled by the host event that spans them. The
profiler slows the host, so the idle share it gives is an upper bound of
the untraced run's.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

LAUNCH_CALLS = ("cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")
LABELLED_GAPS = 200


@dataclasses.dataclass
class TraceReading:
    frames: int
    window_s: float                 # host wall time of the traced steps
    busy_s: float                   # union of device operation intervals
    host_launch_calls: int
    kernel_us: dict                 # name fragment -> [durations in us]
    device_ops: list                # [[name, seconds]] most time first
    idle_gaps: list                 # [[host event, seconds]] longest first


def _union(intervals):
    total, end = 0.0, float("-inf")
    merged = []
    for s, e in sorted(intervals):
        if s > end:
            merged.append([s, e])
            total += e - s
            end = e
        elif e > end:
            total += e - end
            merged[-1][1] = e
            end = e
    return total, merged


def _gap_label(gap_s, gap_e, host):
    """The host event that best explains an idle gap: the shortest one that
    covers at least half of it, else the one that overlaps it most."""
    best, best_key = "host, no traced call", None
    span = gap_e - gap_s
    for s, e, name in host:
        ov = min(e, gap_e) - max(s, gap_s)
        if ov <= 0:
            continue
        key = ((0, e - s) if ov >= 0.5 * span else (1, -ov))
        if best_key is None or key < best_key:
            best, best_key = name, key
    return best


def profile_steps(step, n_steps: int, frames_per_step: int,
                  kernels=("landmark_top2_kernel", "hamming_top2_kernel"),
                  attempts: int = 2) -> TraceReading:
    """Run ``step(i)`` for i < n_steps under the profiler (a synchronize
    at the end only) and read the trace. Tries again, on the next steps,
    where the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile

    cuda_t = torch.autograd.DeviceType.CUDA
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    for attempt in range(attempts):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(n_steps):
                step(attempt * n_steps + i)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        dev = [e for e in events if e.device_type == cuda_t]
        if dev or not on_card:
            break
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != cuda_t]
    calls = collections.Counter(n for _, _, n in host if n.startswith("cuda"))
    launch_calls = sum(c for n, c in calls.items()
                       if n.startswith(LAUNCH_CALLS))
    busy_us, merged = _union([(e.time_range.start, e.time_range.end)
                              for e in dev])
    kernel_us = {k: [e.time_range.end - e.time_range.start for e in dev
                     if k in e.name] for k in kernels}
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name[:160]] += (e.time_range.end - e.time_range.start) * 1e-6
    gaps = collections.Counter()
    if merged:
        lo = min(s for s, _, _ in host) if host else merged[0][0]
        edges = [lo] + [x for m in merged for x in m]
        spans = sorted(((ge - gs, gs, ge) for gs, ge in
                        zip(edges[0::2], edges[1::2]) if ge > gs),
                       reverse=True)
        # the longest gaps by the host event that spans each; the many
        # short ones between back-to-back kernels together
        for n, (d, gs, ge) in enumerate(spans):
            label = (_gap_label(gs, ge, host)[:160] if n < LABELLED_GAPS
                     else "the shorter gaps")
            gaps[label] += d * 1e-6
    return TraceReading(
        frames=n_steps * frames_per_step, window_s=wall,
        busy_s=busy_us * 1e-6, host_launch_calls=launch_calls,
        kernel_us=kernel_us,
        device_ops=[[n, s] for n, s in by_name.most_common(10)],
        idle_gaps=[[n, s] for n, s in gaps.most_common(10)])
