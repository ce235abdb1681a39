"""Shared helpers of the benchmark's CPU tests: cells cut to a size the CPU
runs in seconds, and one run of the harness on the CPU."""

from __future__ import annotations

import copy
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def cpu_cell(workload, frames=40, width=None, height=None, small=False,
             **traffic):
    """The cell ``workload`` with its stream cut to ``frames`` frames (a
    cycling stream keeps its period), optionally at a smaller image and
    with the capacities of the port's small test configuration."""
    from harness import cells

    c = cells.load(workload)
    c.traffic = copy.deepcopy(c.traffic)
    c.config = copy.deepcopy(c.config)
    if width:
        c.config.update(width=width, height=height, cx=width / 2,
                        cy=height / 2)
    if not c.traffic["replay"]["cycles"]:
        c.traffic["rendered_frames"] = frames
    else:
        c.traffic["max_window_frames"] = frames
    c.traffic["settle_s"] = 0
    c.traffic.update(traffic)
    if small:
        c.config["slam_config"].update(
            num_features=300, max_landmarks=8192, max_keyframes=256,
            max_inview_landmarks=512, window_points=2048, window_obs=6144,
            ransac_hypotheses=128, ba_max_iters=10)
    return c


def cpu_measure(cell, calls, seed=2**31 + 5, trace=0):
    """``run.measure`` on the CPU with a window of ``calls`` calls."""
    import torch

    import run as bench_run

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    return bench_run.measure(cell.name, seed, 1e9, trace, device="cpu",
                             cell=cell, max_calls=calls)
