"""The streaming driver's per-frame spans (``utils/profiling.SpanRecorder``)
on the CPU, where its bodies run eagerly and a stage stamp takes the host
clock (``tests/test_torch_cuda.py`` holds the stamps captured in the CUDA
graphs on the card):

- every frame has one ``frame`` span and one body T, and body K or body A
  as its keyframe log says; each body's stages are in order and inside
  it, and no span's children take longer than it;
- the logs, poses and map are bit-equal with the spans on and off, and a
  driver with them off takes no stamp;
- the window BA's live LM bodies per keyframe are the solver's own count
  on the same problem, never above the bodies run;
- the idle split on hand-built spans with known gaps, and the recorder's
  arithmetic (self times, the ring harvested before it wraps, frames past
  the logs dropped) on a hand-driven clock;
- inside ``torch.profiler`` the host spans appear as named ranges.
"""

import numpy as np
import pytest
import torch

from test_streaming import small_config
from vslam_tpu_torch import synthetic
from vslam_tpu_torch.pipeline import streaming
from vslam_tpu_torch.pipeline.streaming import StreamingVO
from vslam_tpu_torch.solvers import ba as tba
from vslam_tpu_torch.utils import profiling

FRAMES = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: both runs sum in the same order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(num_frames=FRAMES, num_points=500, seed=3)


@pytest.fixture(scope="module")
def on_run(seq):
    """A driver with spans on; the window BA's problems and iteration
    counts as the solver returned them, per call."""
    solved = []
    real = tba.solve_ba_schur

    def recorded(prob, **kw):
        poses, points, stats = real(prob, **kw)
        solved.append((prob, kw, int(stats["iterations"])))
        return poses, points, stats

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tba, "solve_ba_schur", recorded)
        vo = StreamingVO(seq.calib, small_config(), max_frames=64,
                         device="cpu", spans=True)
        vo.run(seq.images)
    return vo, solved


@pytest.fixture(scope="module")
def off_run(seq):
    vo = StreamingVO(seq.calib, small_config(), max_frames=64,
                     device="cpu", spans=False)
    vo.run(seq.images)
    return vo


def test_spans_change_no_log_and_off_takes_no_stamp(on_run, off_run):
    on, _ = on_run
    a, b = on.results(), off_run.results()
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for path, t in streaming._tensor_fields(on.state).items():
        assert torch.equal(t, streaming._tensor_fields(off_run.state)[path]), \
            path
    assert off_run.spans is profiling.NO_SPANS and not off_run.spans
    assert profiling.latest_spans() is not off_run.spans


@pytest.mark.parametrize("body", ["track", "keyframe", "advance"])
def test_each_frame_has_its_body_and_stages_nested(on_run, body):
    vo, _ = on_run
    rec = vo.spans
    kf = vo.results()["is_keyframe"]
    assert rec.frames_held(0, FRAMES) == FRAMES
    assert np.isfinite(rec.durations_ms("frame", 0, FRAMES)).all()
    ran = np.isfinite(rec.durations_ms("device." + body, 0, FRAMES))
    want = {"track": np.ones(FRAMES, bool), "keyframe": kf,
            "advance": ~kf}[body]
    np.testing.assert_array_equal(ran, want)
    assert np.isfinite(rec.durations_ms("launch." + body, 0,
                                        FRAMES)).tolist() == want.tolist()
    _, _, iv = rec._intervals(0, FRAMES)
    by = {(n, p): (s, e) for n, p, s, e in iv}
    bs, be = by["device." + body, None]
    fs, fe = by["frame", None]
    ls, le = by["launch." + body, "frame"]
    # eager on the CPU: the body runs inside its launch, inside the frame
    assert (fs[ran] <= ls[ran]).all() and (le[ran] <= fe[ran]).all()
    assert (ls[ran] <= bs[ran]).all() and (be[ran] <= le[ran]).all()
    stages = profiling.BODY_STAGES[body]
    if len(stages) > 2:
        cols = [rec._col[body, s] for s in stages]
        st = rec._stamps[:FRAMES][ran][:, cols]
        assert (np.diff(st, axis=1) >= 0).all()
        kids = [by[f"{body}.{s}", "device." + body] for s in stages[1:]]
        for s, e in kids:
            assert (bs[ran] <= s[ran]).all() and (e[ran] <= be[ran]).all()
        total = sum(e - s for s, e in kids)
        np.testing.assert_allclose(total[ran], (be - bs)[ran], rtol=1e-12)
    # no span's children take longer than it
    for (name, parent), (s, e) in by.items():
        kids = [k for k in by if k[1] == name]
        if not kids:
            continue
        d = e - s
        sum_kids = sum(np.nan_to_num(by[k][1] - by[k][0]) for k in kids)
        ok = np.isfinite(d)
        assert (sum_kids[ok] <= d[ok] * (1 + 1e-12)).all(), name
    got = rec.read(0, FRAMES)
    assert got["spans"]["device." + body]["count"] == want.sum()
    assert got["spans"]["frame"]["count"] == FRAMES


def test_lm_counters_are_the_solvers_iterations(on_run):
    vo, solved = on_run
    kf = vo.results()["is_keyframe"]
    live = vo.spans.counter("lm_live", 0, FRAMES)
    run = vo.spans.counter("lm_run", 0, FRAMES)
    np.testing.assert_array_equal(np.isfinite(live), kf)
    assert len(solved) == kf.sum()
    iters = [n for _, _, n in solved]
    assert live[kf].tolist() == iters
    assert (live[kf] >= 1).all() and (live[kf] <= run[kf]).all()
    assert (run[kf] == small_config().ba_max_iters).all()
    # the same window problem solved again gives the same count
    prob, kw, n = solved[-1]
    assert int(tba.solve_ba_schur(prob, **kw)[2]["iterations"]) == n
    got = vo.spans.read(0, FRAMES)["counters"]
    assert got["lm_live"] == sum(iters) and got["keyframes"] == kf.sum()


def _iv(*pairs):
    return (np.array([p[0] for p in pairs], float),
            np.array([p[1] for p in pairs], float))


def test_idle_split_on_hand_built_spans():
    """Two frames over [0, 100] ns: the card busy over [10, 30], [40, 60]
    and [75, 90]; idle [0, 10] (input 0-4, launch 4-10), [30, 40] (read
    30-36, the rest of the frame 36-40), [60, 75] (the rest of the frame
    60-62, outside 62-66, the next frame's rest 66-70 and launch 70-75)
    and [90, 100] (the rest of the second frame)."""
    busy = _iv((40, 60), (10, 30), (75, 90))
    host = {"input": _iv((0, 4)), "launch": _iv((4, 10), (70, 75)),
            "read": _iv((30, 36)), "frame": _iv((0, 62), (66, 100))}
    got = profiling.idle_split(busy, host, 0.0, 100.0)
    ms = 1e6
    assert got["idle_ms"] * ms == pytest.approx(10 + 10 + 15 + 10)
    assert got["busy_ms"] * ms == pytest.approx(55)
    assert got["idle_share"] == pytest.approx(0.45)
    assert got["input_ms"] * ms == pytest.approx(4)
    assert got["launch_ms"] * ms == pytest.approx(6 + 5)
    assert got["read_ms"] * ms == pytest.approx(6)
    assert got["outside_ms"] * ms == pytest.approx(4)
    assert got["process_frame_ms"] * ms == pytest.approx(4 + 2 + 4 + 10)
    # overlapping busy spans merge; busy time outside the wall is cut off
    got = profiling.idle_split(_iv((-5, 20), (15, 50), (80, 120)),
                               {k: _iv() for k in host}, 0.0, 100.0)
    assert got["idle_ms"] * ms == pytest.approx(30)
    assert got["outside_ms"] * ms == pytest.approx(30)


class _Clock:
    def __init__(self):
        self.t = 1000

    def __call__(self):
        return self.t

    def tick(self, ns):
        self.t += ns


def test_recorder_arithmetic_on_a_hand_driven_clock():
    """Frames of known spans through a 4-frame ring: every frame survives
    the ring's wrap (harvested after each read, every two frames), frames
    past max_frames are dropped, self times are a span less its children,
    and ``clear`` forgets the frames."""
    clock = _Clock()
    rec = profiling.SpanRecorder(8, "cpu", clock=clock, ring_frames=4)
    assert profiling.latest_spans() is rec
    for f in range(10):
        with rec.frame(f):
            clock.tick(10)
            with rec.span("launch.track"):
                clock.tick(5)
                with rec.span("replay.check", "launch.track"):
                    clock.tick(1)
                rec.stamp("track", "start")
                for stage in profiling.BODY_STAGES["track"][1:]:
                    clock.tick(100 * (f + 1))
                    rec.stamp("track", stage)
            with rec.span("read"):
                clock.tick(20)
            rec.after_read(f)
            with rec.span("launch.advance"):
                rec.stamp("advance", "start")
                clock.tick(7)
                rec.stamp("advance", "end")
        clock.tick(50)
    assert rec.frames_held() == 8
    got = rec.read()
    assert got["frames"] == 8 and got["stop"] == 8
    spans = got["spans"]
    track = [5 * 100 * (f + 1) / 1e6 for f in range(8)]
    assert spans["device.track"]["count"] == 8
    assert spans["device.track"]["total_ms"] == pytest.approx(sum(track))
    assert spans["device.track"]["median_ms"] == pytest.approx(
        np.median(track))
    assert spans["device.track"]["self_total_ms"] == pytest.approx(0)
    assert spans["track.pnp"]["median_ms"] == pytest.approx(
        np.median([t / 5 for t in track]))
    assert spans["device.advance"]["median_ms"] == pytest.approx(7e-6)
    launch = [(5 + 1 + 5 * 100 * (f + 1)) / 1e6 for f in range(8)]
    assert spans["launch.track"]["total_ms"] == pytest.approx(sum(launch))
    assert spans["launch.track"]["self_total_ms"] == pytest.approx(
        sum(launch) - 8e-6)
    frame = np.array(launch) + (10 + 20 + 7) / 1e6
    assert spans["frame"]["p99_ms"] == pytest.approx(
        np.percentile(frame, 99))
    assert spans["frame"]["self_median_ms"] == pytest.approx(10e-6)
    assert spans["replay.check"]["parent"] == "launch.track"
    idle = rec.idle(2, 5)
    # the card idles from each frame's start to its body T, through its
    # read, and from body A's end to the frame's end (none: A ends it)
    assert idle["frames"] == 3
    assert idle["launch_ms"] == pytest.approx(3 * 6e-6)
    assert idle["read_ms"] == pytest.approx(3 * 20e-6)
    assert idle["outside_ms"] == pytest.approx(2 * 50e-6)
    rec.clear()
    assert rec.frames_held() == 0 and rec.idle() is None
    with pytest.raises(KeyError):
        rec.durations_ms("no such span")


def test_host_spans_are_profiler_ranges(seq):
    """Inside ``torch.profiler`` each host span is also a named range
    (``profiling.annotate``): what a trace of the command line shows."""
    from torch.profiler import ProfilerActivity, profile

    vo = StreamingVO(seq.calib, small_config(), max_frames=4, device="cpu")
    vo.run(seq.images[:1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vo.run(seq.images[1:2])
    names = {e.name for e in prof.events()}
    assert {"frame", "input.left", "launch.track", "read",
            "launch.advance"} <= names
    assert vo.spans.frames_held() == 2
