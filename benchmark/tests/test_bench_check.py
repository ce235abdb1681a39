"""The correctness check on the CPU, at the cells' image size and feature
count over a short stream: a sound run passes its committed limits, the
frontend control (the plain frontend in bfloat16 in the program's place)
and each fault the cells can have fail them. Faults that these cells
cannot have: half of a batch left out (one stream per driver, no batch),
the exchange between chips left out (one chip). The keyframe share of
each VO traffic mix lies on its side of 1%."""

import numpy as np
import pytest
import torch

from bench_util import cpu_cell, cpu_measure

CALLS = 40


@pytest.fixture(scope="module")
def sound():
    """A sound corridor run at 752x480 and 1500 features, with the frontend
    control's reading."""
    import run as bench_run

    cell = cpu_cell("vo_corridor", frames=16 + CALLS)
    orig = bench_run.evaluate
    held = {}

    def with_control(session, seed, controls=False):
        held.update(orig(session, seed, controls=True))
        return held

    bench_run.evaluate = with_control
    try:
        res, checks, counters = cpu_measure(cell, calls=CALLS)
    finally:
        bench_run.evaluate = orig
    return cell, res, checks, held


def test_a_sound_run_is_correct(sound):
    _, res, checks, _ = sound
    assert res["correct"], checks


def test_the_controls_fail_their_limits(sound):
    """The plain frontend in bfloat16, and every frame answered with the
    pose from before the window (a step that leaves the state
    unchanged), each fail the limit of their number."""
    cell, _, _, readings = sound
    for name, spec in cell.limits["limits"].items():
        assert readings[spec["control"]] > spec["limit"], name


def _faulty_run(monkeypatch, patch):
    from vslam_tpu_torch.pipeline import streaming

    patch(monkeypatch, streaming)
    cell = cpu_cell("vo_corridor", frames=16 + CALLS)
    res, checks, _ = cpu_measure(cell, calls=CALLS)
    return res, checks


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    def patch(mp, streaming):
        def unchanged(self, img_l, img_r):
            self.state = self.state.replace(frame=self.state.frame + 1)
        mp.setattr(streaming.StreamingVO, "process_frame", unchanged)

    res, checks = _faulty_run(monkeypatch, patch)
    assert not res["correct"], checks


def test_an_altered_pose_fails(monkeypatch):
    """Each frame's pose moved by up to 5 cm where the driver writes it."""
    def patch(mp, streaming):
        orig = streaming.StreamingVO.process_frame
        rng = np.random.default_rng(0)

        def altered(self, img_l, img_r):
            orig(self, img_l, img_r)
            p = self.state.cur_pose.clone()
            p[:3] += torch.as_tensor(rng.uniform(-0.05, 0.05, 3),
                                     dtype=p.dtype)
            self.write_state(cur_pose=p)
        mp.setattr(streaming.StreamingVO, "process_frame", altered)

    res, checks = _faulty_run(monkeypatch, patch)
    assert not res["correct"], checks


def test_an_altered_descriptor_fails(monkeypatch):
    """One descriptor bit flipped where the frontend computes it."""
    def patch(mp, streaming):
        from vslam_tpu_torch.ops import describe

        orig = describe.compute_descriptors

        def altered(patches, angles):
            bits = orig(patches, angles).clone()
            bits[..., 0] ^= 1
            return bits
        mp.setattr(describe, "compute_descriptors", altered)

    res, checks = _faulty_run(monkeypatch, patch)
    assert not res["correct"], checks


def test_a_frontend_fault_inside_the_window_fails_the_hover(monkeypatch):
    """The hover makes no keyframe in its window: its frontend is judged
    by the features the tracking step computed for window frames. A
    descriptor bit flipped from the window's start on (the warm-up and
    the bootstrap keyframe sound) fails ``feat_miss``."""
    from harness import drive
    from vslam_tpu_torch.ops import describe

    on = {"window": False}
    orig = describe.compute_descriptors
    window = drive.Session.window

    def altered(patches, angles):
        bits = orig(patches, angles)
        if on["window"]:
            bits = bits.clone()
            bits[..., 0] ^= 1
        return bits

    def in_window(self, *args, **kwargs):
        on["window"] = True
        return window(self, *args, **kwargs)

    monkeypatch.setattr(describe, "compute_descriptors", altered)
    monkeypatch.setattr(drive.Session, "window", in_window)
    cell = cpu_cell("vo_hover", frames=16 + 24, width=320, height=240,
                    small=True)
    res, checks, counters = cpu_measure(cell, calls=24)
    assert counters["keyframes_in_window"] == 0
    limit = cell.limits["limits"]["feat_miss"]["limit"]
    assert checks["feat_miss"]["value"] > limit, checks
    assert not res["correct"]


@pytest.mark.parametrize("workload,above", [("vo_corridor", True),
                                            ("vo_hover", False)])
def test_keyframe_share_is_on_its_side_of_one_percent(workload, above):
    """At the cell's image size and features, over 64 frames after the
    warm-up (the hover replays its 80-frame period): the corridor makes
    keyframes on well over 1% of frames, the hover on none."""
    cell = cpu_cell(workload, frames=16 + 64)
    _, _, counters = cpu_measure(cell, calls=64)
    share = counters["keyframes_in_window"] / counters["frames_in_window"]
    assert (share > 0.03) if above else (share < 0.01), share


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vo_corridor", "vo_hover"])
def test_the_controls_fail_on_the_card(workload):
    """On the card at the cell's size, a short window: the sound readings
    within every limit, and each compared number failed by its control
    (``control.py`` prints the same readings over many seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import control
    from harness import cells

    cell = cells.load(workload)
    r = control.session_readings(cell, 2**31 + 99, 8.0, "cuda",
                                 controls=True)
    for name, spec in cell.limits["limits"].items():
        assert r[name] <= spec["limit"], (name, r[name])
        ctl = r.get(spec["control"])
        if ctl is not None:
            assert ctl > spec["limit"], (name, ctl)
