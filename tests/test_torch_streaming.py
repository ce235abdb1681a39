"""The port's StreamingVO against the JAX package's, end to end and stage
by stage.

End to end: the port's driver on synthetic.generate(num_frames=24,
num_points=500, seed=3) with tests/test_streaming.py's small_config meets
that file's bounds (>= 3 keyframes, tracking held from frame 2 on, median
inliers > 30, keyframe ATE < 0.08 m and within 2x of the JAX driver's,
full-trajectory ATE < 0.10 m). RANSAC draws differ between the two (torch
cannot reproduce jax.random), so the runs are compared by outcome.

Stage by stage: the JAX driver's map state after its run is carried into
the port (``interop``) and each keyframe-path function (stereo matching,
insertion, window eviction, culling, window-problem build and merge) is
run on both sides from the same inputs: integer state equal, floats within
1e-5 (newly triangulated positions within 5e-3 relative, see below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_streaming import small_config
from vslam_tpu.frontend import features as jfeat
from vslam_tpu.pipeline import ba_window as jbaw
from vslam_tpu.pipeline import keyframe as jkf
from vslam_tpu.pipeline import tracking as jtrack
from vslam_tpu.pipeline.streaming import StreamingVO as JaxStreamingVO
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
from vslam_tpu_torch.eval import ate
from vslam_tpu_torch.frontend.features import Features
from vslam_tpu_torch.pipeline import ba_window as tbaw
from vslam_tpu_torch.pipeline import keyframe as tkf
from vslam_tpu_torch.pipeline.streaming import StreamingVO, StreamState


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(num_frames=24, num_points=500, seed=3)


@pytest.fixture(scope="module")
def port_run(seq):
    vo = StreamingVO(seq.calib, small_config(), max_frames=64)
    vo.run(seq.images)
    return vo


@pytest.fixture(scope="module")
def jax_run(seq):
    vo = JaxStreamingVO(seq.calib, small_config(), max_frames=64)
    vo.run(seq.images, sync_every=0)
    jax.block_until_ready(vo.state.frame)
    return vo


def kf_ate(vo, seq):
    fids, pos, _ = vo.keyframe_trajectory()
    return ate.align_svd(pos, seq.poses[fids, :3])[2]


def test_port_tracks_and_maps(port_run, seq):
    res = port_run.results()
    assert res["frames"] == len(seq.images)
    assert res["is_keyframe"][0]
    assert res["is_keyframe"].sum() >= 3
    assert res["tracked_ok"][2:].all()
    assert np.median(res["inliers"][2:]) > 30


def test_port_ate_matches_jax_driver(port_run, jax_run, seq):
    rmse_port = kf_ate(port_run, seq)
    rmse_jax = kf_ate(jax_run, seq)
    assert rmse_port < 0.08, rmse_port
    assert rmse_port < max(2.0 * rmse_jax, 0.05), (rmse_port, rmse_jax)
    # the keyframe cadence follows the same decision rule: the same
    # keyframes up to one frame
    fa, fb = jax_run.keyframe_trajectory()[0], port_run.keyframe_trajectory()[0]
    assert len(fa) == len(fb) and np.abs(fa - fb).max() <= 1, (fa, fb)


def test_port_full_trajectory(port_run, seq):
    res = port_run.results()
    est = res["trajectory"][:, :3]
    _, _, rmse = ate.align_svd(est, seq.poses[:len(est), :3])
    assert rmse < 0.10, rmse


def test_port_reset_reproducible(seq):
    vo = StreamingVO(seq.calib, small_config(), max_frames=32)
    vo.run(seq.images[:6])
    t1 = vo.results()["trajectory"]
    vo.reset()
    vo.run(seq.images[:6])
    np.testing.assert_array_equal(vo.results()["trajectory"], t1)


def test_port_culling_under_pressure(seq):
    """Tiny landmark capacity: culling recycles slots (the streaming
    culling test of the JAX package)."""
    cfg = small_config()
    cfg.max_landmarks = 512
    cfg.lm_cull_pressure = 0.5
    cfg.lm_cull_min_obs = 3
    vo = StreamingVO(seq.calib, cfg, max_frames=64)
    vo.run(seq.images)
    res = vo.results()
    assert res["is_keyframe"].sum() >= 4
    assert res["tracked_ok"][2:].mean() > 0.8
    n_valid = int(vo.state.lm.valid.sum())
    assert 50 < n_valid <= cfg.max_landmarks


# ---------------------------------------------------------------------------
# stage-by-stage parity from the JAX driver's state
# ---------------------------------------------------------------------------

def jax_state(jax_run):
    st = jax_run.state
    return st.kf, st.lm


def port_state(jax_run):
    kf, lm = jax_state(jax_run)
    return (interop.from_arrays(KeyframeState, kf._asdict()),
            interop.from_arrays(LandmarkState, lm._asdict()))


def assert_same(port_obj, jax_obj, atol=1e-5, rtol=None):
    """Integer and boolean fields equal; float fields within atol, or
    within a per-field relative tolerance ``rtol[name]``."""
    got = interop.to_arrays(port_obj)
    want = jax_obj._asdict() if hasattr(jax_obj, "_asdict") else jax_obj
    for name, value in got.items():
        ref = np.asarray(want[name])
        if value.dtype.kind == "f":
            r = (rtol or {}).get(name, 0)
            np.testing.assert_allclose(value, ref, atol=atol, rtol=r,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(value, ref.astype(value.dtype),
                                          err_msg=name)


def test_interop_roundtrip(jax_run):
    st = jax_run.state
    port = interop.from_arrays(StreamState, st._asdict())
    assert port.frame == int(st.frame)
    assert port.kf.desc.dtype == torch.uint8 and port.lm.valid.dtype == \
        torch.bool
    assert_same(port.kf, st.kf, atol=0)
    assert_same(port.lm, st.lm, atol=0)
    np.testing.assert_array_equal(interop.to_arrays(port)["traj"],
                                  np.asarray(st.traj))


def keyframe_inputs(jax_run, seq, frame=23):
    """Tracking + stereo results for one frame on the JAX side."""
    cfg = small_config()
    st = jax_run.state
    img_l, img_r = seq.images[frame]
    res = jtrack.track_frame(
        jax.random.PRNGKey(1), jnp.asarray(img_l), st.lm, st.cur_pose,
        st.last_pose, st.vel, st.intr0, cam_name="pinhole",
        num_features=cfg.num_features, inview_cap=cfg.max_inview_landmarks,
        width=seq.calib.width, height=seq.calib.height,
        num_hypotheses=cfg.ransac_hypotheses)
    feats_r = jfeat.extract_features(jnp.asarray(img_r),
                                     num_features=cfg.num_features)
    stereo_j, stereo_inl = jkf.stereo_match(res.feats, feats_r, st.T_0_1,
                                            st.intr0, st.intr1,
                                            cam_name="pinhole")
    return res, feats_r, stereo_j, stereo_inl


def tt(x):
    return torch.as_tensor(np.array(x))


def test_stereo_match_and_insert_keyframe_match_jax(jax_run, seq):
    st = jax_run.state
    res, feats_r, stereo_j, stereo_inl = keyframe_inputs(jax_run, seq)
    fl = interop.from_arrays(Features, res.feats)
    fr = interop.from_arrays(Features, feats_r)
    sj, sinl = tkf.stereo_match(fl, fr, tt(st.T_0_1), tt(st.intr0),
                                tt(st.intr1), cam_name="pinhole")
    np.testing.assert_array_equal(sinl.numpy(), np.asarray(stereo_inl))
    np.testing.assert_array_equal(sj.numpy(), np.asarray(stereo_j))
    assert int(sinl.sum()) > 50

    # two features matched to one landmark: the canonical dedupe keeps the
    # lower-index one, so every scatter row is written once
    match_lm = np.array(res.match_lm)
    inlier = np.array(res.inlier)
    tracked = np.flatnonzero(inlier & (match_lm >= 0))
    assert len(tracked) > 20
    match_lm[tracked[-1]] = match_lm[tracked[0]]

    out_j = jkf.insert_keyframe(
        st.kf, st.lm, jnp.asarray(30, jnp.int32), st.last_kf_slot,
        res.T_w_c, st.T_0_1, res.feats, feats_r, stereo_j, stereo_inl,
        jnp.asarray(match_lm), jnp.asarray(inlier), st.intr0, st.intr1,
        cam_name="pinhole")
    kf, lm = port_state(jax_run)
    obs_before = (lm.all_kf >= 0).sum(dim=1)
    out_t = tkf.insert_keyframe(
        kf, lm, 30, tt(st.last_kf_slot), tt(res.T_w_c), tt(st.T_0_1), fl, fr,
        tt(stereo_j), tt(stereo_inl), tt(match_lm), tt(inlier), tt(st.intr0),
        tt(st.intr1), cam_name="pinhole")
    assert_same(out_t.kf, out_j.kf)
    # new landmarks: float32 midpoint triangulation over an 11 cm baseline
    # is ill-conditioned for far points (the ray-angle determinant
    # cancels), and XLA's fused evaluation rounds apart from the eager one
    # by an ulp there: 5e-3 relative (the same eager arithmetic agrees
    # exactly, see test_torch_geometry)
    assert_same(out_t.lm, out_j.lm, rtol={"pos": 5e-3, "pos_c": 5e-3})
    np.testing.assert_array_equal(out_t.covis_weight.numpy(),
                                  np.asarray(out_j.covis_weight))
    assert int(out_t.num_new) == int(out_j.num_new) > 0
    # the duplicated landmark got exactly one left+right observation pair
    dup = int(match_lm[tracked[0]])
    added = int((out_t.lm.all_kf[dup] >= 0).sum() - obs_before[dup])
    assert added in (1, 2)
    mp = out_t.kf.map_points[int(out_t.slot)]
    valid_mp = mp[mp >= 0]
    assert len(valid_mp.unique()) == len(valid_mp)


def test_window_eviction_and_culling_match_jax(jax_run):
    kf_j, lm_j = jax_state(jax_run)
    kf_t, lm_t = port_state(jax_run)
    act = np.asarray(kf_j.valid & kf_j.active)
    deact = act.copy()
    deact[np.flatnonzero(act)[2:]] = False     # evict the two oldest
    kj, lj = jkf.deactivate_keyframes(kf_j, lm_j, jnp.asarray(deact))
    kt, lt = tkf.deactivate_keyframes(kf_t, lm_t, tt(deact))
    assert_same(kt, kj)
    assert_same(lt, lj)
    kj2, lj2, nj = jkf.cull_landmarks(kj, lj, min_lifetime_obs=3)
    kt2, lt2, nt = tkf.cull_landmarks(kt, lt, min_lifetime_obs=3)
    assert int(nt) == int(nj) > 0
    assert_same(kt2, kj2)
    assert_same(lt2, lj2)


def test_window_problem_and_merge_match_jax(jax_run):
    cfg = small_config()
    st = jax_run.state
    kf_j, lm_j = jax_state(jax_run)
    kf_t, lm_t = port_state(jax_run)
    kw = dict(W2=cfg.window_cams // 2, Lw=cfg.window_points, O=cfg.window_obs)
    wj = jbaw.build_window_problem(kf_j, lm_j, st.intr0, st.intr1, **kw)
    wt = tbaw.build_window_problem(kf_t, lm_t, tt(st.intr0), tt(st.intr1),
                                   **kw)
    assert_same(wt.prob, wj.prob, atol=0)
    for name in ("sel_kf", "sel_kf_valid", "sel_lm", "sel_lm_valid",
                 "obs_dropped"):
        np.testing.assert_array_equal(getattr(wt, name).numpy(),
                                      np.asarray(getattr(wj, name)),
                                      err_msg=name)
    assert int(wt.prob.obs_valid.sum()) > 100

    rng = np.random.RandomState(0)
    poses = np.asarray(wj.prob.poses) + rng.normal(
        0, 1e-3, wj.prob.poses.shape).astype(np.float32)
    points = np.asarray(wj.prob.points) + rng.normal(
        0, 1e-3, wj.prob.points.shape).astype(np.float32)
    kj, lj = jbaw.merge_window_result(kf_j, lm_j, wj, jnp.asarray(poses),
                                      jnp.asarray(points))
    kt, lt = tbaw.merge_window_result(kf_t, lm_t, wt, tt(poses), tt(points))
    assert_same(kt, kj)
    assert_same(lt, lj)


def test_run_window_ba_matches_jax(jax_run):
    """Build, solve and merge in one call, from the JAX driver's map with
    its keyframe poses perturbed: poses and points within 1e-4, as the
    solver's own parity test (tests/test_torch_ba.py)."""
    cfg = small_config()
    st = jax_run.state
    kf_j, lm_j = jax_state(jax_run)
    rng = np.random.RandomState(1)
    noise = rng.normal(0, 2e-3, np.asarray(kf_j.pose_l).shape)
    noise[:, 3:] = 0.0
    kf_j = kf_j._replace(pose_l=kf_j.pose_l + noise.astype(np.float32))
    kf_t, lm_t = (interop.from_arrays(KeyframeState, kf_j._asdict()),
                  interop.from_arrays(LandmarkState, lm_j._asdict()))
    kw = dict(cam_name="pinhole", max_iters=5, W2=cfg.window_cams // 2,
              Lw=cfg.window_points, O=cfg.window_obs)
    kj, lj, sj = jbaw.run_window_ba(kf_j, lm_j, st.intr0, st.intr1, **kw)
    kt, lt, stt = tbaw.run_window_ba(kf_t, lm_t, tt(st.intr0), tt(st.intr1),
                                     **kw)
    assert float(stt["final_cost"]) < float(stt["initial_cost"])
    np.testing.assert_allclose(float(stt["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-4)
    assert int(stt["obs_dropped"]) == int(sj["obs_dropped"])
    np.testing.assert_allclose(kt.pose_l.numpy(), np.asarray(kj.pose_l),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(lt.pos.numpy(), np.asarray(lj.pos),
                               atol=1e-4, rtol=1e-4)


def test_port_lost_frames_and_options_match_jax(seq):
    """kf_require_tracked and suppress_duplicate_landmarks on, with two
    blank frames: the port and the JAX driver lose the same frames, refuse
    keyframes while lost, and keep the same cadence. (A blank frame still
    yields corners, all of response 0, with all-zero descriptors; the
    second blank frame passes the match count but localizes on a handful of
    inliers, and neither driver recovers on this short sequence.)"""
    cfg = small_config()
    cfg.kf_require_tracked = True
    cfg.suppress_duplicate_landmarks = True
    frames = list(seq.images[:14])
    blank = np.zeros_like(frames[0][0])
    for i in (6, 7):
        frames[i] = (blank, blank)
    port = StreamingVO(seq.calib, cfg, max_frames=32)
    port.run(frames)
    ref = JaxStreamingVO(seq.calib, cfg, max_frames=32)
    ref.run(frames, sync_every=0)
    rp, rj = port.results(), ref.results()
    assert rp["tracked_ok"][1:6].all() and not rp["tracked_ok"][6]
    assert not rp["tracked_ok"][8:].any()
    np.testing.assert_array_equal(rp["tracked_ok"], rj["tracked_ok"])
    assert not (rp["is_keyframe"][1:] & ~rp["tracked_ok"][1:]).any()
    fa, fb = ref.keyframe_trajectory()[0], port.keyframe_trajectory()[0]
    assert len(fa) == len(fb) and np.abs(fa - fb).max() <= 1, (fa, fb)
