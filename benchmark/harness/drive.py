"""Set-up, warm-up and the measured window of one cell.

The program under test is ``vslam_tpu_torch``, through the driver file
that the cell's configuration names (``benchmark/drivers/<driver>.py``).
Closed loop: the next call is made as soon as the previous one returns.
Each call is timed from handing its frames over until their poses have
been copied to the host.

In the window the harness also keeps a sample of the program's frontend
answers, drawn from the seed (reservoir sampling over the window's
calls): after a sampled call, the newest frame's features as the step
computed them, copied on the device into buffers made before the window,
for the check after the window (``check.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import cells, geometry, stream


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers and the check."""
    cell: object
    device: torch.device
    setup_s: float = 0.0
    first_frame: int = 0            # stream index of the window's first
    frames: int = 0                 # frames completed in the window
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    frames_per_call: int = 1
    poses: Optional[np.ndarray] = None          # [frames, 7] read per call
    is_keyframe: Optional[np.ndarray] = None    # [frames] window frames
    tracked: Optional[np.ndarray] = None        # [frames]
    peak_reserved_bytes: int = 0
    capture_stats: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    trace: object = None            # trace.TraceReading (--trace 1)
    held_pose: Optional[np.ndarray] = None      # the last pose before it
    # sampled frontend answers: [(stream frame, corners, bits, valid)]
    frontend: list = dataclasses.field(default_factory=list)
    median_ms_by_third: list = dataclasses.field(default_factory=list)


class Session:
    """One cell's program, stream and window."""

    def __init__(self, cell, seed: int, device, t_start: float):
        from vslam_tpu_torch.config import SlamConfig
        from vslam_tpu_torch.io.calib import Calibration

        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        tr, conf = cell.traffic, cell.config
        phases = self.setup_phases = {}
        t = time.perf_counter()
        phases["start"] = t - t_start
        self.rig = geometry.rig_of(conf)
        self.world = stream.build(tr, self.rig, seed, self.device)
        phases["world"] = -t + (t := time.perf_counter())
        self.calib = Calibration(
            T_i_c=self.rig.T_i_c, intrinsics=self.rig.intrinsics,
            cam_types=[conf["camera_model"]] * 2, width=self.rig.width,
            height=self.rig.height)
        self.cfg = SlamConfig(**conf["slam_config"])
        self.adapter = cells.module("drivers", conf["driver"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.run = Run(cell=cell, device=self.device,
                       frames_per_call=tr.get("frames_per_call", 1))
        self.driver = self.adapter.make(self.calib, self.cfg,
                                        self._max_frames(), self.device,
                                        **conf.get("driver_args", {}))
        phases["driver"] = -t + (t := time.perf_counter())
        self.next_frame = 0
        # warm-up: every body captured, every shape of the window used
        for _ in range(0, tr["warmup_frames"], self.run.frames_per_call):
            held = self.step()
        self._sync()
        self.run.held_pose = held[-1].numpy().astype(np.float64)
        phases["warm_up"] = -t + (t := time.perf_counter())
        # on the card a process's graph launches run ~20% slower for its
        # first tens of seconds, idle or busy (PERF.md, section 2): the
        # window opens ``settle_s`` after the run's start
        time.sleep(max(0.0, tr.get("settle_s", 0) - (t - t_start)))
        phases["settle"] = time.perf_counter() - t
        self.run.first_frame = self.next_frame
        # set-up's work, without the idle wait, which would hide it
        self.run.setup_s = t - t_start

    # ------------------------------------------------------------------

    def _max_frames(self) -> int:
        """The driver's log length: every frame a run can reach."""
        tr = self.cell.traffic
        if not self.world.cycles:
            return len(self.world.poses)
        return tr["warmup_frames"] + tr["max_window_frames"]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        """One call of the program; returns the poses [k, 7] it read."""
        n, f0 = self.run.frames_per_call, self.next_frame
        if f0 + n > self._max_frames():
            raise RuntimeError(
                f"stream frame {f0 + n - 1} is past the {self._max_frames()} "
                f"frames this traffic provides: the run outlasted its stream")
        self.next_frame += n
        return self.adapter.step(
            self.driver, [self.world.frame(f) for f in range(f0, f0 + n)])

    # ------------------------------------------------------------------

    def window(self, seconds: float, max_calls: Optional[int] = None):
        """The measured window: calls until ``seconds`` have passed (or,
        for a rehearsal, ``max_calls`` calls were made)."""
        from vslam_tpu_torch.ops import cuda_hamming

        run, drv, adapter = self.run, self.driver, self.adapter
        launches0 = dict(cuda_hamming.LAUNCHES)
        pick = np.random.default_rng([abs(self.seed), 11])
        answer = adapter.frontend_answer(drv)
        k = self.cell.traffic["check_frames"] if answer is not None else 0
        bufs = [tuple(torch.empty_like(x) for x in answer) for _ in range(k)]
        taken = [None] * k
        poses, lat = [], []
        self._sync()
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            poses.append(self.step())
            b = time.perf_counter()
            # reservoir sampling (Algorithm R) over the window's calls
            i = len(lat)
            j = i if i < k else int(pick.integers(0, i + 1))
            if j < k:
                for dst, src in zip(bufs[j], adapter.frontend_answer(drv)):
                    dst.copy_(src, non_blocking=True)
                taken[j] = self.next_frame - 1
            lat.append(b - a)
            if b - t0 >= seconds or len(lat) == max_calls:
                break
        run.window_s = time.perf_counter() - t0
        # a run's speed can change once inside the window (PERF.md,
        # section 2): the median call in each third shows where
        third = [lat[i * len(lat) // 3:(i + 1) * len(lat) // 3]
                 for i in range(3)]
        run.median_ms_by_third = [
            float(np.median(t)) * 1e3 if t else None for t in third]
        if self.device.type == "cuda":
            run.peak_reserved_bytes = torch.cuda.max_memory_reserved(self.device)
        run.latencies_s = lat
        run.frames = len(lat) * run.frames_per_call
        run.launches = {n: cuda_hamming.LAUNCHES[n] - c
                        for n, c in launches0.items()}
        run.capture_stats = dict(getattr(drv, "capture_stats", {}))
        run.frontend = [(f, *(x.cpu() for x in buf))
                        for f, buf in zip(taken, bufs) if f is not None]
        res = adapter.results(drv)
        w = slice(run.first_frame, run.first_frame + run.frames)
        run.is_keyframe = res["is_keyframe"][w]
        run.tracked = res["tracked_ok"][w]
        run.poses = torch.cat(poses).numpy().astype(np.float64)

    def traced(self, steps: int):
        """A profiled stretch of ``steps`` more calls after the window."""
        from . import trace

        self.run.trace = trace.profile_steps(
            lambda i: self.step(), steps, self.run.frames_per_call)

    def counters(self) -> dict:
        """The driver file's counts, where it keeps any."""
        read = getattr(self.adapter, "counters", None)
        return read(self.driver) if read else {}

    def truth(self, first: int, n: int) -> np.ndarray:
        """Ground-truth poses [n, 7] of stream frames first..first+n-1."""
        w = self.world
        return np.stack([w.poses[w.index(f)] for f in range(first, first + n)])
