"""The fleet cell (``vo_x8_corridors``: eight rigs in lockstep through
``drivers/multiseq_vo.py``) on the CPU: the fleet world and trajectory
interleave the rigs as stated, the driver file maps lockstep frames to
stream frames, the cell loads from ``BENCHMARK.json``, on a short
rehearsal a sound run is correct while a cross-rig fault (each rig's
frontend answers taken from the rig before it) fails ``correct``, and
over a window as long as the card's runs the cell's limits refuse the
pose faults planted in single rigs (``fleet_control.py``)."""

import types

import numpy as np
import pytest
import torch

from bench_util import cpu_cell, cpu_measure

CALLS = 6


def _cells():
    from harness import cells

    return cells


def test_fleet_trajectory_interleaves_the_rigs():
    cells = _cells()
    spec = dict(speeds=[0.02, 0.03, 0.05], sway=[[0, 0.4, 170.0]],
                yaw=[[0.12, 42.3]])
    fleet = cells.module("trajectories", "fleet")
    P = fleet.poses(spec, 3 * 40)
    path = cells.module("trajectories", "path")
    # stream frame 3 t + j is rig (t + j + 1) mod 3 at its frame t
    rig = [[(t + j + 1) % 3 for j in range(3)] for t in range(40)]
    for s, v in enumerate(spec["speeds"]):
        want = path.poses(dict(velocity=[0, 0, v], sway=spec["sway"],
                               yaw=spec["yaw"]), 40)
        idx = [3 * t + rig[t].index(s) for t in range(40)]
        np.testing.assert_array_equal(P[idx], want)
        np.testing.assert_array_equal(
            fleet.stream_index(s, np.arange(40), 3), idx)
        got_rig, got_t = fleet.rig_at(np.asarray(idx), 3)
        assert (got_rig == s).all() and (got_t == np.arange(40)).all()
    # a lockstep frame's newest stream frame is rig t mod 3's
    assert [rig[t][-1] for t in range(6)] == [0, 1, 2, 0, 1, 2]
    # every rig starts at the identity pose
    np.testing.assert_array_equal(P[:3], np.tile([0, 0, 0, 0, 0, 0, 1.0],
                                                 (3, 1)))
    with pytest.raises(ValueError, match="whole number"):
        cells.module("trajectories", "fleet").poses(spec, 100)


def test_fleet_world_renders_each_rig_in_its_own_world():
    """Rig s's frames are kind ``sprites`` rendered alone from
    ``layout_seeds[s]``, the textures dealt by the same generator in rig
    order; two rigs' worlds differ."""
    from harness import geometry

    cells = _cells()
    rig = geometry.make_rig(160, 120, 110.0, 110.0, 80.0, 60.0, 0.11)
    spec = dict(speeds=[0.02, 0.04])
    poses = cells.module("trajectories", "fleet").poses(spec, 2 * 6)
    world = dict(box=[[-8, 8], [-3, 3], [2, 14]], box_follows_path=True,
                 points_per_m3=1.0416666666666667, layout_seeds=[1001, 1002])
    left, right = cells.module("worlds", "sprite_fleet").render(
        world, rig, poses, np.random.RandomState(5), "cpu")
    sprites = cells.module("worlds", "sprites")
    rng = np.random.RandomState(5)
    base = {k: v for k, v in world.items() if k != "layout_seeds"}
    for s, seed in enumerate(world["layout_seeds"]):
        # rig s's frames t = 0..5 sit at stream frames 2 t + (s - t - 1) % 2
        idx = [2 * t + (s - t - 1) % 2 for t in range(6)]
        l, r = sprites.render(dict(base, layout_seed=seed), rig,
                              poses[idx], rng, "cpu")
        np.testing.assert_array_equal(left[idx], l)
        np.testing.assert_array_equal(right[idx], r)
    assert (left[0] != left[1]).mean() > 0.1


class _Feats:
    def __init__(self, S, N):
        self.corners = torch.arange(S * N * 2, dtype=torch.float32).reshape(
            S, N, 2)
        self.bits = torch.zeros((S, N, 256), dtype=torch.uint8)
        self.valid = torch.ones((S, N), dtype=torch.bool)


def test_driver_file_maps_lockstep_frames_to_stream_frames():
    """``step`` hands stream frame S t + j to rig (t + j + 1) mod S and
    returns the poses in stream order; ``results`` puts [S, t] logs in
    stream order, ``keyframe_answers`` labels rig s's keyframe of
    lockstep frame t with its stream frame, and ``frontend_answer`` is
    rig t mod S's (the call's newest stream frame)."""
    cells = _cells()
    drv_mod = cells.module("drivers", "multiseq_vo")
    S, T, K, N = 3, 4, 5, 2
    kf_log = np.zeros((S, T), bool)
    kf_log[0, 0] = kf_log[2, 1] = kf_log[1, 3] = True
    ok = ~kf_log
    fid = np.full((S, K), -1, np.int32)
    valid = np.zeros((S, K), bool)
    for s, t in ((0, 0), (2, 1), (1, 3)):
        fid[s, 0], valid[s, 0] = t, True
    kf = types.SimpleNamespace(
        frame_id=torch.as_tensor(fid), valid=torch.as_tensor(valid),
        corners=torch.arange(S * K * 2 * N * 2, dtype=torch.float32)
        .reshape(S, K, 2, N, 2),
        desc=torch.zeros((S, K, 2, N, 32), dtype=torch.uint8),
        kp_valid=torch.ones((S, K, 2, N), dtype=torch.bool))
    handed = []
    state = types.SimpleNamespace(
        kf=kf, frame=T, pose=torch.arange(S, dtype=torch.float32)[:, None]
        .expand(S, 7))
    drv = types.SimpleNamespace(
        S=S, state=state,
        process_frames=lambda left, right: handed.append((left, right)),
        results=lambda: dict(is_keyframe=kf_log, tracked_ok=ok),
        observed_tracking=types.SimpleNamespace(
            res=types.SimpleNamespace(feats=_Feats(S, N))))
    # (rig, t): (0, 0) -> 0 + 2, (2, 1) -> 3 + 0, (1, 3) -> 9 + 0
    res = drv_mod.results(drv)
    assert np.flatnonzero(res["is_keyframe"]).tolist() == [2, 3, 9]
    np.testing.assert_array_equal(res["tracked_ok"], ~res["is_keyframe"])
    got = drv_mod.keyframe_answers(drv, first_frame=0)
    assert [f for f, *_ in got] == [2, 3, 9]
    assert torch.equal(got[1][1], kf.corners[2, 0])
    assert [f for f, *_ in drv_mod.keyframe_answers(drv, 4)] == [9]
    # after lockstep frame T - 1 = 3 the newest stream frame is rig 0's
    c, _, _ = drv_mod.frontend_answer(drv)
    assert torch.equal(c, drv.observed_tracking.res.feats.corners[0])
    state.frame = T + 1
    c, _, _ = drv_mod.frontend_answer(drv)
    assert torch.equal(c, drv.observed_tracking.res.feats.corners[1])
    # lockstep frame 4: stream slots j = 0, 1, 2 are rigs 2, 0, 1
    state.frame = 4
    frames = [(np.full((2, 2), j, np.uint8), np.full((2, 2), 10 + j,
                                                     np.uint8))
              for j in range(S)]
    poses = drv_mod.step(drv, frames)
    left, right = handed[-1]
    assert left[:, 0, 0].tolist() == [1, 2, 0]
    assert right[:, 0, 0].tolist() == [11, 12, 10]
    assert poses[:, 0].tolist() == [2.0, 0.0, 1.0]


def test_the_cell_loads_from_benchmark_json():
    from harness import cells

    cell = cells.load("vo_x8_corridors")
    S = cell.config["driver_args"]["num_sequences"]
    tr = cell.traffic
    assert S == 8 == tr["frames_per_call"]
    assert len(tr["trajectory"]["speeds"]) == len(
        tr["world"]["layout_seeds"]) == S
    assert tr["warmup_frames"] % S == 0 and tr["rendered_frames"] % S == 0
    assert cell.config["slam_config"] == cells.load(
        "vo_corridor").config["slam_config"]
    assert set(cell.limits["limits"]) == {"feat_miss", "ape_med_mm",
                                          "rpe_p90_mm"}
    # neighbouring rigs in the stream part by 0.6 cm a frame or more
    v = np.asarray(tr["trajectory"]["speeds"])
    assert sorted(v) == pytest.approx(0.024 + 0.002 * np.arange(S))
    assert np.abs(v - np.roll(v, 1)).min() >= 0.006 - 1e-9
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "lockstep_track_device_ms", "kf_service_device_ms",
        "ba_service_device_ms", "kf_wait_frames", "lockstep_idle_share"}


def _rehearsal(monkeypatch=None, fault=False):
    from harness import cells

    cell = cpu_cell("vo_x8_corridors", frames=8 * (16 + CALLS + 4),
                    width=320, height=240, small=True)
    if fault:
        mod = cells.module("drivers", "multiseq_vo")
        answer, kf_answers = mod.frontend_answer, mod.keyframe_answers

        def shifted_answer(drv):     # rig s - 1's features for rig s
            out = answer(drv)
            if out is None:
                return None
            s = (drv.state.frame - 2) % drv.S
            f = drv.observed_tracking.res.feats
            return f.corners[s], f.bits[s], f.valid[s]

        def shifted_keyframes(drv, first_frame):   # rig s - 1's for rig s
            fleet = cells.module("trajectories", "fleet")
            out = []
            for f, *rest in kf_answers(drv, 0):
                s, t = fleet.rig_at(f, drv.S)
                g = int(fleet.stream_index((s + 1) % drv.S, t, drv.S))
                if g >= first_frame:
                    out.append((g, *rest))
            return sorted(out, key=lambda a: a[0])

        monkeypatch.setattr(mod, "frontend_answer", shifted_answer)
        monkeypatch.setattr(mod, "keyframe_answers", shifted_keyframes)
    return cpu_measure(cell, calls=CALLS, trace=1)


def test_a_sound_rehearsal_is_correct_and_reads_every_metric():
    res, checks, counters = _rehearsal()
    assert res["correct"], checks
    assert res["attempted"] == 8 * CALLS and res["failed"] == 0
    assert set(res["metrics"]) == {
        "lockstep_track_device_ms", "kf_service_device_ms",
        "ba_service_device_ms", "kf_wait_frames", "lockstep_idle_share"}
    assert counters["keyframes_per_rig"] and min(
        counters["keyframes_per_rig"]) >= 1


def test_a_cross_rig_fault_fails(monkeypatch):
    res, checks, _ = _rehearsal(monkeypatch, fault=True)
    assert not res["correct"], checks
    assert checks["feat_miss"]["value"] > checks["feat_miss"]["limit"]


WINDOW_LOCKSTEP_FRAMES = 662    # the shortest window of the card's runs


def test_the_limits_refuse_pose_faults_in_single_rigs():
    """``fleet_control.planted`` on the cell's own trajectory: each fault
    changes just the frames it names (a frozen rig holds its pose before
    the window; a shifted rig takes rig s - 1's pose of the same lockstep
    frame), and with the ground truth in place of sound answers the
    cell's limits refuse every rig frozen alone, half the rigs frozen,
    every rig shifted and rig 0 shifted (rig 7 at 3.8 cm a frame answers
    for rig 0 at 2.4), over a window as short as the card's runs made.
    A single rig shifted onto a neighbour 0.6-0.8 cm a frame apart is
    not refused (PERF.md, section 7)."""
    import fleet_control
    from harness import cells, check

    cell = cells.load("vo_x8_corridors")
    tr = cell.traffic
    S = tr["frames_per_call"]
    first = tr["warmup_frames"]
    n = S * WINDOW_LOCKSTEP_FRAMES
    fleet = cells.module("trajectories", "fleet")
    truth_all = fleet.poses(tr["trajectory"], first + n)
    truth = truth_all[first:]
    rig, t = fleet.rig_at(first + np.arange(n), S)
    held = np.stack([truth_all[fleet.stream_index(s, first // S - 1, S)]
                     for s in range(S)])
    faults = fleet_control.planted(truth, first, held)
    for k in range(S):
        changed = (faults[f"frozen_{k}"] != truth).any(1)
        assert not changed[rig != k].any()
        np.testing.assert_array_equal(faults[f"frozen_{k}"][rig == k],
                                      np.broadcast_to(held[k], (n // S, 7)))
        m = rig == k
        src = fleet.stream_index((k - 1) % S, t[m], S) - first
        np.testing.assert_array_equal(faults[f"shifted_{k}"][m], truth[src])
        assert not (faults[f"shifted_{k}"] != truth)[~m].any()
    sound = dict(feat_miss=0.0,
                 **check.pose_readings(truth, truth, truth_all[0]))
    assert check.judge(sound, cell.limits)[0]
    for name in [f"frozen_{k}" for k in range(S)] + [
            "frozen_half", "shifted_all", "shifted_0"]:
        r = check.pose_readings(faults[name], truth, truth_all[0])
        ok, checks = check.judge(dict(sound, **r), cell.limits)
        assert not ok, (name, checks)
