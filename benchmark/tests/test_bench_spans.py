"""The readers of the program's spans (``benchmark/metrics/*.py`` that read
``vslam_tpu_torch.utils.profiling.latest_spans()``) on a synthetic run:
a CPU ``SpanRecorder`` driven by a hand-set clock, so every span is
known, and a harness ``Run`` whose window is frames 2-9 of 12. Each
reader gives its number from the window's frames only, and None where
the recorder holds no window frame or the program has no recorder."""

import numpy as np
import pytest

import bench_util  # noqa: F401  (puts the harness on the path)

FIRST, FRAMES, TOTAL = 2, 8, 12
KEYFRAMES = (0, 4, 7, 11)


class _Clock:
    def __init__(self):
        self.t = 10_000

    def __call__(self):
        return self.t

    def tick(self, us):
        self.t += int(us * 1000)


def _track_us(f):
    """Body T's stages in us: extract, project, k1, pnp, decide."""
    return (500, 100, 50, 5000 + 100 * f, 200)


def _keyframe_us(f):
    return (800, 200, 1900, 400, 250, 20000 + 1000 * f, 150, 350)


def _drive(profiling):
    """Frames 0-11 through the recorder: each frame 100 us of input, 300
    us launching T (its address check 80 us), body T, a 40 us read after
    it, then K (keyframes) or A (400 us) launched for 200 us, and 1 ms
    outside ``process_frame``; frame f's BA runs 20 LM bodies, 5 + f of
    them live."""
    clock = _Clock()
    rec = profiling.SpanRecorder(TOTAL, "cpu", clock=clock, ring_frames=8)
    for f in range(TOTAL):
        kf = f in KEYFRAMES
        with rec.frame(f):
            with rec.span("input.left"):
                clock.tick(100)
            with rec.span("launch.track"):
                with rec.span("replay.check", "launch.track"):
                    clock.tick(80)
                clock.tick(220)
            # the body runs after its launch returns
            rec.stamp("track", "start")
            for stage, us in zip(profiling.BODY_STAGES["track"][1:],
                                 _track_us(f)):
                clock.tick(us)
                rec.stamp("track", stage)
            with rec.span("read"):
                clock.tick(40)
            rec.after_read(f)
            body = "keyframe" if kf else "advance"
            with rec.span("launch." + body):
                clock.tick(200)
        rec.stamp(body, "start")
        if kf:
            for stage, us in zip(profiling.BODY_STAGES["keyframe"][1:],
                                 _keyframe_us(f)):
                clock.tick(us)
                rec.stamp("keyframe", stage)
            rec.count("lm_live", 5 + f)
            rec.count("lm_run", 20)
        else:
            clock.tick(400)
            rec.stamp("advance", "end")
        clock.tick(1000)
    with rec.setup("first_run.track"):
        clock.tick(2_000_000)
    with rec.setup("first_run.keyframe"):
        clock.tick(500_000)
    return rec


@pytest.fixture
def run_and_rec():
    from harness.drive import Run
    from vslam_tpu_torch.utils import profiling

    rec = _drive(profiling)
    kf = np.array([f in KEYFRAMES for f in range(TOTAL)])
    run = Run(cell=None, device="cpu", first_frame=FIRST, frames=FRAMES,
              is_keyframe=kf[FIRST:FIRST + FRAMES])
    return run, rec


def _read(name, run):
    from harness import cells

    return cells.reader(name)(run)


def test_readers_give_the_window_numbers(run_and_rec):
    run, _ = run_and_rec
    window = range(FIRST, FIRST + FRAMES)
    kfs = [f for f in window if f in KEYFRAMES]
    tracking = [f for f in window if f not in KEYFRAMES]
    assert kfs == [4, 7]
    assert _read("track_device_ms", run) == pytest.approx(
        np.median([sum(_track_us(f)) / 1e3 for f in tracking]))
    assert _read("pnp_device_ms", run) == pytest.approx(
        np.median([_track_us(f)[3] / 1e3 for f in window]))
    assert _read("keyframe_device_ms", run) == pytest.approx(
        np.median([sum(_keyframe_us(f)) / 1e3 for f in kfs]))
    assert _read("window_ba_device_ms", run) == pytest.approx(
        np.median([sum(_keyframe_us(f)[4:7]) / 1e3 for f in kfs]))
    assert _read("ba_live_share", run) == pytest.approx(
        sum(5 + f for f in kfs) / (20 * len(kfs)))
    # frame less read: input, launch T, body T, launch K or A
    assert _read("host_busy_ms_per_frame", run) == pytest.approx(
        np.median([(100 + 300 + sum(_track_us(f)) + 200) / 1e3
                   for f in window]))
    # idle inside launches: launching T (300 us) every frame; K and A are
    # launched while T's read has returned and nothing runs (200 us)
    assert _read("launch_idle_ms_per_frame", run) == pytest.approx(0.5)
    def after_t(f):      # body K or A, which runs after the frame's end
        return sum(_keyframe_us(f)) if f in KEYFRAMES else 400

    # from the first window frame's start to the last one's end (frame 9,
    # whose body A runs after it)
    wall = sum(100 + 300 + sum(_track_us(f)) + 40 + 200 + after_t(f) + 1000
               for f in window) - after_t(9) - 1000
    busy = sum(sum(_track_us(f)) for f in window) + sum(
        after_t(f) for f in window if f != 9)
    assert _read("window_idle_share", run) == pytest.approx(1 - busy / wall)
    assert _read("first_run_s", run) == pytest.approx(2.5)


def test_readers_read_nothing_outside_the_window(run_and_rec, monkeypatch):
    from vslam_tpu_torch.utils import profiling

    names = ("track_device_ms", "pnp_device_ms", "keyframe_device_ms",
             "window_ba_device_ms", "ba_live_share", "host_busy_ms_per_frame",
             "launch_idle_ms_per_frame", "window_idle_share", "first_run_s")
    run, _ = run_and_rec
    run.first_frame = TOTAL           # no window frame in the recorder
    assert all(_read(n, run) is None for n in names)
    run.first_frame = FIRST
    # a program without the recorder (the parent of the spans)
    monkeypatch.delattr(profiling, "latest_spans")
    assert all(_read(n, run) is None for n in names)
