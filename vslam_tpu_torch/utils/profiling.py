"""Tracing / profiling hooks.

Port of ``vslam_tpu/utils/profiling.py`` onto ``torch.profiler``: a trace
capture (a Chrome trace, viewable in Perfetto or chrome://tracing) plus
the wall-clock stage timers of ``utils/metrics.StageTimer``; and the two
timings the measurement tools and ``chip_smoke.py`` take of one call:
``wall_ms`` (blocking) and ``device_ms`` (a profiler window).

``SpanRecorder`` keeps the streaming driver's per-frame spans: stage
stamps taken inside its step's bodies (on the card, kernels captured
into the CUDA graphs), host spans of ``process_frame`` and counters, all
on the host's ``perf_counter_ns`` clock; ``latest_spans()`` is the newest
driver's recorder.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Optional

import numpy as np
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
    """Named range for host-side stages (shows up in the trace as a host
    range). Not a ``record_function`` user annotation: the profiler gives
    those a device-side copy over the kernels launched inside them, which
    would count a host span's whole reach as device time."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(name) if fast else torch.profiler.record_function(name)


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


# ---------------------------------------------------------------------------
# per-frame spans of the streaming driver
# ---------------------------------------------------------------------------

# the stage boundaries each body of ``pipeline/streaming.StreamingVO``
# stamps, in order: a stage (span ``<body>.<stage>``) runs from the
# previous boundary's stamp to its own, a body (span ``device.<body>``)
# from its first stamp to its last; body A has no stage inside
BODY_STAGES = {
    "track": ("start", "extract", "project", "k1", "pnp", "decide"),
    "keyframe": ("start", "extract_right", "k2", "insert", "evict_cull",
                 "ba_build", "ba_solve", "ba_merge", "advance"),
    "advance": ("start", "end"),
}
# counters body K writes per keyframe: the window BA's LM bodies that did
# work (``solve_ba_schur``'s iterations) and the bodies run
COUNTERS = ("lm_live", "lm_run")
# host spans of ``process_frame``: (name, parent)
HOST_SPANS = (
    ("frame", None), ("input.left", "frame"), ("launch.track", "frame"),
    ("replay.check", "launch.track"), ("read", "frame"),
    ("input.right", "frame"), ("launch.keyframe", "frame"),
    ("replay.check", "launch.keyframe"), ("launch.advance", "frame"),
    ("replay.check", "launch.advance"))
IDLE_HOST = {"launch": ("launch.track", "launch.keyframe", "launch.advance"),
             "read": ("read",), "input": ("input.left", "input.right")}
RING_FRAMES = 1024

_latest = None


def latest_spans():
    """The ``SpanRecorder`` of the newest streaming driver built with spans
    on (None before the first): how a reader outside the driver (the
    benchmark's metrics) finds the spans of the run it measured."""
    return _latest


class _HostSpan:
    """One host span kind: a context manager that writes the host clock
    into the open frame's row, and enters ``annotate(name)`` while a
    ``torch.profiler`` is active."""

    __slots__ = ("rec", "col", "name", "rf")

    def __init__(self, rec, col, name):
        self.rec, self.col, self.name, self.rf = rec, col, name, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = annotate(self.name)
            self.rf.__enter__()
        rec = self.rec
        rec._host_start[rec._row, self.col] = rec.clock()

    def __exit__(self, *exc):
        rec = self.rec
        rec._host_end[rec._row, self.col] = rec.clock()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class _FrameSpan(_HostSpan):
    __slots__ = ()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.rec._row = self.rec.max_frames   # outside a frame


class _SetupSpan:
    """A set-up span (``first_run.<body>``): host clock around the block."""

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.t0 = self.rec.clock()

    def __exit__(self, *exc):
        self.rec._setup.append((self.name, self.t0, self.rec.clock()))


_NULL = contextlib.nullcontext()   # a span that takes no stamp


class NoSpans:
    """The recorder of a driver built with ``spans=False``: every span is
    a no-op and no stamp is taken."""

    def __bool__(self):
        return False

    def frame(self, frame):
        return _NULL

    def span(self, name, parent="frame"):
        return _NULL

    def setup(self, name):
        return _NULL

    def stamp(self, body, stage):
        pass

    def count(self, name, value):
        pass

    def after_read(self, frame):
        pass

    def calibrate(self):
        pass

    def clear(self):
        pass


NO_SPANS = NoSpans()


class SpanRecorder(NoSpans):
    """Per-frame spans and counters of one streaming driver.

    A span has a name, a frame (the driver's frame index), its parent's
    name, and a start and an end in host ``perf_counter_ns``
    (``clock``). Three sources:

    - Stage stamps (``stamp(body, stage)``, ``BODY_STAGES``) at the stage
      boundaries inside the step's bodies. On the card a stamp is a
      one-thread kernel (``ops/cuda_stamp``) that writes the device's
      nanosecond timer into slot [frame mod ``RING_FRAMES``, stage] of a
      ring of pinned host memory that the device maps, the frame read on
      the device from the driver's counter (``frame_dev``): captured into
      a CUDA graph it is one more node, with no host read and no launch
      of its own. On the CPU it takes the host clock. Counters
      (``count``) go into the same ring. The ring is harvested into host
      arrays sized from ``max_frames`` after a frame's ``do_kf`` read,
      every half ring (the frames before it have completed then), and
      when read. Device stamps are mapped onto the host clock by
      calibrations (a stamp launched between two host clock reads around
      a synchronize): at the driver's first capture, at every harvest,
      and when read, interpolated between them (``read()["clock"]``
      gives their drift).
    - Host spans (``span``, ``HOST_SPANS``): the host clock into arrays
      sized from ``max_frames``; inside a ``torch.profiler`` they also
      enter ``annotate(name)``.
    - Set-up spans (``setup``): each body's first eager run
      (``first_run.<body>``) and the kernel library's load
      (``kernel_library``, ``ops/cuda_hamming.LOADED``).

    Nothing is allocated and nothing is read back from the card per
    frame. Reading (``read``, ``durations_ms``, ``counter``, ``idle``,
    ``setup_s``) takes a frame range and synchronizes the card first.
    """

    def __init__(self, max_frames: int, device, clock=time.perf_counter_ns,
                 ring_frames: int = RING_FRAMES):
        global _latest
        self.max_frames = max_frames
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.clock = clock
        self.frame_dev = None        # the driver's device frame counter
        self._col = {}
        for body, stages in BODY_STAGES.items():
            for stage in stages:
                self._col[body, stage] = len(self._col)
        for name in COUNTERS:
            self._col[name] = len(self._col)
        self.rows, self.cols = ring_frames, len(self._col)
        self._ring_t = torch.zeros((self.rows, self.cols), dtype=torch.int64,
                                   pin_memory=self.cuda)
        self._ring = self._ring_t.numpy()
        self._ring_dev = None        # its device address (first stamp)
        if self.cuda:
            self._cal_t = torch.zeros((1, 1), dtype=torch.int64,
                                      pin_memory=True)
            self._cal_dev = None
        self._stamps = np.zeros((max_frames, self.cols), np.int64)
        # row max_frames takes the spans outside a frame or past the logs
        self._host_start = np.zeros((max_frames + 1, len(HOST_SPANS)),
                                    np.int64)
        self._host_end = np.zeros_like(self._host_start)
        self._host = {key: _HostSpan(self, i, key[0])
                      for i, key in enumerate(HOST_SPANS)}
        self._host["frame", None] = self._frame_span = _FrameSpan(
            self, 0, "frame")
        self._setup = []             # (name, start, end)
        self._cal = []               # (host ns, device ns, half-width ns)
        self.clear()
        _latest = self

    def __bool__(self):
        return True

    def clear(self):
        """Forget every frame (the driver's ``reset``); set-up spans and
        calibrations stay."""
        self._ring[:] = 0
        self._stamps[:] = 0
        self._host_start[:] = 0
        self._host_end[:] = 0
        self._row = self.max_frames
        self._ring_row = 0
        self._frames = 0             # one past the newest frame opened
        self._harvested = 0          # frames before it are harvested
        self._collected = None       # _frames at the last read

    # -- recording ---------------------------------------------------------

    def frame(self, frame: int):
        """The ``frame`` span of frame ``frame``, which opens its row."""
        self._row = frame if 0 <= frame < self.max_frames else self.max_frames
        self._ring_row = frame % self.rows
        self._frames = max(self._frames, frame + 1)
        self._collected = None
        return self._frame_span

    def span(self, name: str, parent: str = "frame"):
        """The host span ``name`` under ``parent`` (``HOST_SPANS``)."""
        return self._host[name, parent]

    def setup(self, name: str):
        return _SetupSpan(self, name)

    def _device_ring(self) -> int:
        if self._ring_dev is None:
            from ..ops import cuda_stamp

            self._ring_dev = cuda_stamp.mapped_pointer(self._ring_t)
            self._cal_dev = cuda_stamp.mapped_pointer(self._cal_t)
        return self._ring_dev

    def stamp(self, body: str, stage: str):
        col = self._col[body, stage]
        if self.cuda:
            from ..ops import cuda_stamp

            cuda_stamp.stamp(self.frame_dev, self._device_ring(), self.rows,
                             self.cols, col)
        else:
            self._ring[self._ring_row, col] = self.clock()

    def count(self, name: str, value):
        """Write ``value`` (a 0-dim int32 tensor on the driver's device, or
        an int) into the open frame's counter ``name``."""
        col = self._col[name]
        if self.cuda:
            from ..ops import cuda_stamp

            cuda_stamp.count(self.frame_dev, value, self._device_ring(),
                             self.rows, self.cols, col)
        elif torch.is_tensor(value):
            self._ring_t[self._ring_row, col].copy_(value)
        else:
            self._ring[self._ring_row, col] = value

    def after_read(self, frame: int):
        """Called once frame ``frame``'s ``do_kf`` has been read: every
        earlier frame has completed, and the card's queue is empty."""
        if frame - self._harvested >= self.rows // 2:
            self._harvest(frame)
            self.calibrate(samples=1)

    def _harvest(self, stop: int):
        idx = np.arange(self._harvested, stop)
        rows = idx % self.rows
        keep = idx < self.max_frames
        self._stamps[idx[keep]] = self._ring[rows[keep]]
        self._ring[rows] = 0
        self._harvested = stop

    def calibrate(self, samples: int = 3):
        """One point of the card's clock against the host's: of
        ``samples`` stamps, each launched between two host clock reads
        around a synchronize, the one in the narrowest bracket."""
        if not self.cuda or torch.cuda.is_current_stream_capturing():
            return
        from ..ops import cuda_stamp

        self._device_ring()
        torch.cuda.synchronize(self.device)
        best = None
        for _ in range(samples):
            h0 = self.clock()
            cuda_stamp.stamp(None, self._cal_dev, 1, 1, 0)
            torch.cuda.synchronize(self.device)
            h1 = self.clock()
            if best is None or h1 - h0 < 2 * best[2]:
                best = ((h0 + h1) // 2, int(self._cal_t[0, 0]),
                        (h1 - h0) // 2)
        self._cal.append(best)

    # -- reading -----------------------------------------------------------

    def _collect(self):
        """Harvest every frame opened so far (after a synchronize), and
        calibrate, unless nothing ran since the last time."""
        if self._collected == self._frames:
            return
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.calibrate()
        self._harvest(self._frames)
        self._collected = self._frames

    def _to_host(self, stamps):
        """Stamps (0 where absent) on the host clock, float ns (NaN where
        absent): as taken on the CPU; on the card through the
        calibrations, the offset interpolated linearly in device time."""
        t = stamps.astype(np.float64)
        if self.cuda and self._cal:
            cal = np.asarray(self._cal, dtype=np.int64)
            d0, h0 = cal[0, 1], cal[0, 0]
            rel = (stamps - d0).astype(np.float64)
            off = ((cal[:, 1] - d0) - (cal[:, 0] - h0)).astype(np.float64)
            order = np.argsort(cal[:, 1], kind="stable")
            t = h0 + rel - np.interp(rel, (cal[order, 1] - d0).astype(
                np.float64), off[order])
        return np.where(stamps > 0, t, np.nan)

    def _range(self, first, stop):
        self._collect()
        stop = self._frames if stop is None else stop
        return max(0, first), max(0, min(stop, self._frames,
                                         self.max_frames))

    def _intervals(self, first, stop):
        """(a, b, [(name, parent, start [b-a], end [b-a])]) on the host
        clock in float ns, NaN where the span did not run."""
        a, b = self._range(first, stop)
        out = []
        hs, he = self._host_start[a:b], self._host_end[a:b]
        for i, (name, parent) in enumerate(HOST_SPANS):
            ok = (hs[:, i] > 0) & (he[:, i] > 0)
            out.append((name, parent,
                        np.where(ok, hs[:, i].astype(np.float64), np.nan),
                        np.where(ok, he[:, i].astype(np.float64), np.nan)))
        t = self._to_host(self._stamps[a:b])
        for body, stages in BODY_STAGES.items():
            cols = [self._col[body, stage] for stage in stages]
            out.append(("device." + body, None, t[:, cols[0]],
                        t[:, cols[-1]]))
            if len(cols) == 2:
                continue
            for prev, cur, stage in zip(cols, cols[1:], stages[1:]):
                out.append((f"{body}.{stage}", "device." + body,
                            t[:, prev], t[:, cur]))
        return a, b, out

    def frames_held(self, first: int = 0, stop: Optional[int] = None) -> int:
        """Frames of [first, stop) that have a ``frame`` span."""
        a, b = self._range(first, stop)
        return int(np.count_nonzero(self._host_end[a:b, 0] > 0))

    def durations_ms(self, name: str, first: int = 0,
                     stop: Optional[int] = None):
        """Per frame of [first, stop): span ``name``'s duration in ms (the
        sum over its parents where it has several), NaN where absent."""
        _, _, iv = self._intervals(first, stop)
        ds = [e - s for n, _, s, e in iv if n == name]
        if not ds:
            raise KeyError(name)
        d = np.stack(ds)
        return np.where(np.isnan(d).all(0), np.nan, np.nansum(d, 0)) / 1e6

    def counter(self, name: str, first: int = 0, stop: Optional[int] = None):
        """Per frame of [first, stop): counter ``name``, NaN where body K
        did not run."""
        a, b = self._range(first, stop)
        ran = self._stamps[a:b, self._col["keyframe", "start"]] > 0
        return np.where(ran, self._stamps[a:b, self._col[name]].astype(
            np.float64), np.nan)

    def idle(self, first: int = 0, stop: Optional[int] = None):
        """The card's idle time over [first, stop), as the gaps between its
        bodies' spans from the first ``frame`` span's start to the last's
        end, split by the host span over each gap (``idle_split``); None
        without a frame."""
        _, _, iv = self._intervals(first, stop)
        by = {(n, p): (s, e) for n, p, s, e in iv}
        fs, fe = by["frame", None]
        if not np.isfinite(fe).any():
            return None

        def cat(names):
            s = np.concatenate([by[n, p][0] for n, p in by if n in names])
            e = np.concatenate([by[n, p][1] for n, p in by if n in names])
            ok = np.isfinite(s) & np.isfinite(e)
            return s[ok], e[ok]

        busy = cat(tuple("device." + b for b in BODY_STAGES))
        host = {k: cat(v) for k, v in IDLE_HOST.items()}
        host["frame"] = cat(("frame",))
        out = idle_split(busy, host, np.nanmin(fs), np.nanmax(fe))
        out["frames"] = int(np.isfinite(fe).sum())
        return out

    def setup_s(self) -> dict:
        """Set-up spans in seconds (summed by name)."""
        from ..ops import cuda_hamming

        spans = list(self._setup)
        if cuda_hamming.LOADED is not None:
            spans.append(("kernel_library", *cuda_hamming.LOADED))
        out = {}
        for name, t0, t1 in spans:
            out[name] = out.get(name, 0.0) + (t1 - t0) / 1e9
        return out

    def read(self, first: int = 0, stop: Optional[int] = None) -> dict:
        """Everything over frames [first, stop): per span name its count,
        median, p99 and total ms and its self time (its duration less its
        children's) median and total; the counters summed over body K's
        frames; the idle split; the set-up spans; the clock calibration
        (points, drift in ppm, the last bracket's half-width in us)."""
        a, b, iv = self._intervals(first, stop)
        dur = [e - s for _, _, s, e in iv]
        agg = {}
        for (name, parent, _, _), d in zip(iv, dur):
            kids = [k for (n, p, _, _), k in zip(iv, dur) if p == name]
            own = d - (np.nansum(np.stack(kids), 0) if kids else 0.0)
            ok = np.isfinite(d)
            row = agg.setdefault(name, dict(parents=[], d=[], own=[]))
            if ok.any() and parent not in row["parents"]:
                row["parents"].append(parent)
            row["d"].append(d[ok] / 1e6)
            row["own"].append(own[ok] / 1e6)
        spans = {}
        for name, row in agg.items():
            d, own = np.concatenate(row["d"]), np.concatenate(row["own"])
            if not len(d):
                continue
            spans[name] = dict(
                parent=(row["parents"][0] if len(row["parents"]) == 1
                        else row["parents"]),
                count=len(d), median_ms=float(np.median(d)),
                p99_ms=float(np.percentile(d, 99)), total_ms=float(d.sum()),
                self_median_ms=float(np.median(own)),
                self_total_ms=float(own.sum()))
        counters = {name: float(np.nansum(self.counter(name, a, b)))
                    for name in COUNTERS}
        counters["keyframes"] = int(np.isfinite(
            self.counter(COUNTERS[0], a, b)).sum())
        clock = None
        if self._cal:
            cal = np.asarray(self._cal, dtype=np.int64)
            span_ns = cal[-1, 0] - cal[0, 0]
            drift = ((cal[-1, 1] - cal[-1, 0]) - (cal[0, 1] - cal[0, 0]))
            clock = dict(points=len(cal),
                         drift_ppm=(float(drift / span_ns * 1e6)
                                    if span_ns else None),
                         half_width_us=float(cal[-1, 2] / 1e3))
        return dict(first=a, stop=b, frames=self.frames_held(a, b),
                    spans=spans, counters=counters, idle=self.idle(a, b),
                    setup_s=self.setup_s(), clock=clock)


def _merge(s, e):
    """Sorted, disjoint union of the intervals [s, e)."""
    if not len(s):
        return s, e
    o = np.argsort(s, kind="stable")
    s, e = s[o], e[o]
    run = np.maximum.accumulate(e)
    new = np.r_[True, s[1:] > run[:-1]]
    starts = np.flatnonzero(new)
    return s[new], np.maximum.reduceat(e, starts)


def _covered(s, e, x):
    """Length of the union of disjoint sorted [s, e) up to each x."""
    if not len(s):
        return np.zeros_like(x)
    cum = np.r_[0.0, np.cumsum(e - s)]
    i = np.searchsorted(s, x, side="right")
    j = np.maximum(i - 1, 0)
    part = np.clip(x - s[j], 0.0, e[j] - s[j])
    return np.where(i > 0, cum[j] + part, 0.0)


def idle_split(busy, host: dict, w0: float, w1: float) -> dict:
    """The card's idle time over the wall range [w0, w1] (host ns): the
    gaps between the ``busy`` intervals ((starts, ends)), split by the
    host spans over them. ``host`` maps "launch", "read", "input" and
    "frame" to (starts, ends); a gap's time under a launch, read or input
    span counts there, under a frame but none of those as
    "process_frame", under no frame as "outside". Returns ms, and
    ``idle_share`` (idle over wall)."""
    bs, be = _merge(np.clip(busy[0], w0, w1), np.clip(busy[1], w0, w1))
    gs, ge = np.r_[w0, be], np.r_[bs, w1]
    ok = ge > gs
    gs, ge = gs[ok], ge[ok]
    cover = {k: (_covered(*_merge(*host[k]), ge)
                 - _covered(*_merge(*host[k]), gs)).sum()
             for k in ("launch", "read", "input", "frame")}
    wall, idle = w1 - w0, (ge - gs).sum()
    ms = 1e-6
    return dict(wall_ms=wall * ms, busy_ms=(wall - idle) * ms,
                idle_ms=idle * ms,
                idle_share=float(idle / wall) if wall > 0 else None,
                launch_ms=cover["launch"] * ms, read_ms=cover["read"] * ms,
                input_ms=cover["input"] * ms,
                process_frame_ms=(cover["frame"] - cover["launch"]
                                  - cover["read"] - cover["input"]) * ms,
                outside_ms=(idle - cover["frame"]) * ms)
