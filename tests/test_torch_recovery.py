"""The drivers' recovery branches in the port, with the JAX tests' bars.

- Sustained-loss re-bootstrap (tests/test_rebootstrap.py): worlds 3 and
  11 cut together through ``StreamingVO`` with ``kf_require_tracked``; at
  ``lost_rebootstrap_frames=4`` a keyframe lands after the threshold and
  tracking resumes, at 0 the map freezes. Both runs lose, keyframe and
  recover on the same frames as the JAX driver's. The re-bootstrap step
  itself, from the JAX driver's state before it with its RANSAC draws
  injected: the same decision, the same keyframe and landmarks.
- Blackout recovery in the faithful driver
  (tests/test_fault_recovery.py::test_blackout_recovery): three blank
  frames, then the held view re-acquired; the frame that recovers, from
  the JAX driver's checkpoint before it with its draws injected, gives
  the JAX driver's matches and pose.
- Blackout plus teleport in ``StreamingSLAM``
  (tests/test_streaming_reloc.py::test_streaming_blackout_teleport_recovery,
  ``poll_every=2``): no relocalization on featureless frames, BoW + PnP
  recovery within a poll quantum and 0.3 m, tracking resumes.
- Duplicate-landmark suppression in the faithful driver
  (tests/test_dedup_landmarks.py::test_duplicate_suppression): fewer
  landmarks, keyframe ATE < max(1.5 x the unsuppressed run's, 0.12 m).
- VO under photometric degradation
  (tests/test_photometric_robustness.py::test_vo_survives_photometric_
  degradation): at least 3 keyframes, ATE < 0.15 m, median inliers > 20,
  tracked share > 0.9.

End-to-end runs are compared by those bars (RANSAC streams differ between
the packages, hazard e); a single step is compared with the JAX package's
draws injected.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_photometric_robustness as jphoto
import test_rebootstrap as jreboot
from test_streaming_reloc import _reloc_config
from vslam_tpu.config import SlamConfig as JaxSlamConfig
from vslam_tpu.pipeline.slam import SlamSystem as JaxSlamSystem
from vslam_tpu.pipeline.streaming import StreamingVO as JaxStreamingVO
from vslam_tpu.solvers import pnp as jpnp
from vslam_tpu.utils import checkpoint as jcheckpoint
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.eval import ate
from vslam_tpu_torch.frontend.features import extract_features
from vslam_tpu_torch.geometry import lie
from vslam_tpu_torch.loop import vocabulary as tvocab
from vslam_tpu_torch.pipeline import tracking as ttracking
from vslam_tpu_torch.pipeline.slam import SlamSystem
from vslam_tpu_torch.pipeline.streaming import (StreamingSLAM, StreamingVO,
                                                 StreamState)
from vslam_tpu_torch.utils import checkpoint as tcheckpoint


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(jax_cfg, **kw):
    """The JAX package's SlamConfig as the port's."""
    return SlamConfig(**{**dataclasses.asdict(jax_cfg), **kw})


def kf_ate(drv, seq):
    fids, pos, _ = drv.keyframe_trajectory()
    return ate.align_svd(pos, seq.poses[fids, :3])[2], len(fids)


def injecting(monkeypatch, key, num_hypotheses):
    """Route the port's next ``track_frame`` call through the JAX
    package's RANSAC draws from ``key`` over that call's matches (which do
    not depend on the draws: a first call with any draws gives them);
    later calls draw from their generator. Returns the list of pending
    injections (empty once used)."""
    real = ttracking.track_frame
    pending = [key]

    def track_frame(*args, **kw):
        if pending:
            kw.pop("generator", None)
            H = torch.zeros((num_hypotheses, 6), dtype=torch.int64)
            m_ok = real(*args, sample_idx=H, **kw).match_lm >= 0
            kw["sample_idx"] = torch.as_tensor(np.array(
                jpnp._sample_minimal(pending.pop(),
                                     jnp.asarray(m_ok.numpy()),
                                     num_hypotheses, 6)))
        return real(*args, **kw)

    monkeypatch.setattr(ttracking, "track_frame", track_frame)
    return pending


# ---------------------------------------------------------------------------
# sustained-loss re-bootstrap (StreamingVO)
# ---------------------------------------------------------------------------

CUT = 8


@pytest.fixture(scope="module")
def reboot_worlds():
    # world B's texture is unrelated to A's: tracking cannot survive the
    # cut, but B's frames carry plenty of features (unlike a blackout)
    a = synthetic.generate(num_frames=10, num_points=500, seed=3)
    b = synthetic.generate(num_frames=14, num_points=500, seed=11)
    return a, b, list(a.images[:CUT]) + list(b.images)


@pytest.fixture(scope="module")
def reboot_runs(reboot_worlds):
    """Both packages' runs at lost_rebootstrap_frames 4 and 0."""
    a, _, frames = reboot_worlds
    out = {}
    for reboot in (4, 0):
        vo = StreamingVO(a.calib, port(jreboot._cfg(reboot)), max_frames=40,
                         device="cpu")
        vo.run(frames)
        ref = JaxStreamingVO(a.calib, jreboot._cfg(reboot), max_frames=40)
        ref.run(frames, sync_every=0)
        out[reboot] = vo.results(), ref.results()
    return out


def assert_same_decisions(got, want):
    for name in ("tracked_ok", "is_keyframe"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert np.abs(got["inliers"] - want["inliers"]).max() <= 5


def test_rebootstrap_resumes_mapping(reboot_runs):
    res, ref = reboot_runs[4]
    ok = np.asarray(res["tracked_ok"])
    kf = np.asarray(res["is_keyframe"])
    assert ok[:CUT].sum() >= 6, "world-A segment should track"
    assert not ok[CUT:CUT + 3].any(), "the cut must lose tracking"
    # a re-bootstrap keyframe lands once the loss exceeds the threshold
    reboot_kfs = np.nonzero(kf[CUT:])[0]
    assert len(reboot_kfs) >= 1, "no re-bootstrap keyframe inserted"
    assert reboot_kfs[0] >= 4, "re-bootstrap fired before the threshold"
    # and tracking RESUMES against the re-bootstrapped map
    assert ok[CUT + int(reboot_kfs[0]) + 1:].sum() >= 3, (
        "tracking did not resume after the re-bootstrap")
    assert_same_decisions(res, ref)


def test_rebootstrap_disabled_freezes_map(reboot_runs):
    res, ref = reboot_runs[0]
    ok = np.asarray(res["tracked_ok"])
    kf = np.asarray(res["is_keyframe"])
    assert not kf[CUT:].any(), "0 must disable the re-bootstrap"
    assert not ok[CUT + 1:].any(), "without re-bootstrap the loss is permanent"
    assert_same_decisions(res, ref)


def test_rebootstrap_step_matches_jax(reboot_worlds, reboot_runs,
                                      monkeypatch):
    """The frame that re-bootstraps, from the JAX driver's state before it
    and with its draws: a keyframe while lost, the loss count reset, the
    same keyframe record and the same map up to float32 rounding."""
    a, _, frames = reboot_worlds
    kf_frames = np.flatnonzero(reboot_runs[4][1]["is_keyframe"])
    f = int(kf_frames[kf_frames >= CUT][0])
    ref = JaxStreamingVO(a.calib, jreboot._cfg(4), max_frames=40)
    ref.run(frames[:f], sync_every=0)
    before = jax.device_get(ref.state)   # the JAX step donates its state
    assert int(before.lost_run) >= 4
    ref.run(frames[f:f + 1], sync_every=0)
    after = jax.device_get(ref.state)

    vo = StreamingVO(a.calib, port(jreboot._cfg(4)), max_frames=40,
                     device="cpu")
    vo.state = interop.from_arrays(StreamState, before._asdict(), "cpu")
    # the JAX step's tracking key
    _, key = jax.random.split(jnp.asarray(before.key))
    pending = injecting(monkeypatch, key, vo.cfg.ransac_hypotheses)
    vo.process_frame(*frames[f])
    assert not pending
    new = vo.state
    assert bool(new.log_kf[f]) and bool(after.log_kf[f])
    assert not bool(new.log_ok[f]) and not bool(after.log_ok[f])
    assert int(new.lost_run) == int(after.lost_run) == 0
    assert int(new.last_kf_slot) == int(after.last_kf_slot)
    for name in ("frame_id", "valid", "active", "parent", "kp_valid",
                 "map_points", "next_slot"):
        np.testing.assert_array_equal(getattr(new.kf, name).numpy(),
                                      np.asarray(getattr(after.kf, name)),
                                      err_msg=name)
    np.testing.assert_allclose(new.kf.pose_l.numpy(), after.kf.pose_l,
                               atol=1e-3)
    for name in ("valid", "from_kf", "obs_kf", "all_kf"):
        np.testing.assert_array_equal(getattr(new.lm, name).numpy(),
                                      np.asarray(getattr(after.lm, name)),
                                      err_msg=name)
    np.testing.assert_allclose(new.cur_pose.numpy(), after.cur_pose,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# blackout recovery in the faithful driver
# ---------------------------------------------------------------------------

BLACKOUT = (8, 9, 10)


def blackout_config():
    """tests/test_fault_recovery.py's configuration."""
    return JaxSlamConfig(
        num_features=400, ransac_hypotheses=128, max_landmarks=8192,
        max_keyframes=64, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=8,
        enable_relocalization=True, enable_loop_closure=False,
        new_kf_min_inliers=40, vocab_depth=3, quality_level=0.001)


def blackout_frames(seq):
    """The test's 16 frames: frames 8-10 blank, the camera holding frame
    8's view through frame 11, frames 12-15 replaying it."""
    blank = np.full_like(seq.images[0][0], 100)
    return [(blank, blank) if f in BLACKOUT else
            seq.images[min(f, 8) if f <= 11 else 8] for f in range(16)]


@pytest.fixture(scope="module")
def blackout_seq():
    return synthetic.generate(num_frames=16, num_points=500, seed=3)


def test_blackout_recovery(blackout_seq):
    seq = blackout_seq
    slam = SlamSystem(seq.calib, port(blackout_config()), device="cpu")
    lost_frames, recovered = 0, False
    for f, (img_l, img_r) in enumerate(blackout_frames(seq)):
        info = slam.process_frame(img_l, img_r)
        if f in BLACKOUT:
            assert not info["ok"]
            lost_frames += 1
        elif f == 11:
            recovered = info["ok"]
    assert lost_frames == 3
    assert recovered, "tracking did not re-acquire after blackout"
    # state never went non-finite
    assert torch.isfinite(slam.track.current_pose).all()
    fids, est_pos, _ = slam.keyframe_trajectory()
    assert np.all(np.isfinite(est_pos))


def test_blackout_recovery_step_matches_jax(blackout_seq, tmp_path,
                                            monkeypatch):
    """Frame 11, the first view after the blackout, from the JAX driver's
    checkpoint and with its draws: recovered in both, the same matches and
    inliers, the same pose."""
    seq = blackout_seq
    frames = blackout_frames(seq)
    jslam = JaxSlamSystem(seq.calib, blackout_config())
    for img_l, img_r in frames[:11]:
        jslam.process_frame(img_l, img_r)
    ckpt = str(tmp_path / "ckpt")
    jcheckpoint.save(jslam, ckpt)
    _, key = jax.random.split(jslam._key)   # the driver's next key
    want = jslam.process_frame(*frames[11])
    assert want["ok"] and want["kind"] == "track"

    slam = tcheckpoint.load(
        SlamSystem(seq.calib, port(blackout_config()), device="cpu"), ckpt,
        device="cpu")
    assert not slam.tracking_ok and slam.frame == 11
    pending = injecting(monkeypatch, key, slam.cfg.ransac_hypotheses)
    info = slam.process_frame(*frames[11])
    assert not pending
    assert info == want, (info, want)
    np.testing.assert_allclose(slam.trajectory[-1], jslam.trajectory[-1],
                               atol=1e-4)


# ---------------------------------------------------------------------------
# blackout + teleport in StreamingSLAM
# ---------------------------------------------------------------------------

def test_streaming_blackout_teleport_recovery(blackout_seq):
    seq = blackout_seq
    pool = []
    for f in (0, 3, 6, 9):
        ft = extract_features(torch.as_tensor(seq.images[f][0]),
                              num_features=400, quality_level=0.001)
        pool.append(ft.bits[ft.valid].numpy())
    voc = tvocab.train(np.concatenate(pool), k=10, depth=3, seed=0)
    tvocab.set_idf_weights(voc, pool)
    slam = StreamingSLAM(seq.calib, port(_reloc_config()), voc,
                         max_frames=64, poll_every=2, device="cpu")

    # ---- build the map (polls populate the recognition database) ----
    for f in range(12):
        slam.process_frame(*seq.images[f])
        slam.poll()
    assert len(slam.detector.db.bow_of) >= 3, "BoW database populated"

    # ---- fault: sensor blackout while the tracker is teleported ----
    bad_pose = torch.tensor([50.0, 20.0, -30.0, 0, 0, 0, 1.0])
    slam.state = slam.state.replace(
        cur_pose=bad_pose, last_pose=bad_pose.clone(),
        vel=lie.identity_pose())
    blank = np.full_like(seq.images[0][0], 100)
    for _ in range(3):
        slam.process_frame(blank, blank)
        slam.poll()
    # blackout frames carry no features: no PnP attempt on them
    assert not slam.reloc_events, "reloc attempted on featureless frames"

    # ---- the camera re-sees a mapped view: recovery must come from the
    # BoW+PnP path (guided matching is hopeless from 60 m away) ----
    recovered_at = None
    for i in range(6):
        slam.process_frame(*seq.images[6])
        slam.poll()
        if any(ok for _, ok in slam.reloc_events):
            recovered_at = i
            break
    assert recovered_at is not None, (
        f"stream did not relocalize: events={slam.reloc_events}")
    assert recovered_at <= 3, "recovery took more than one poll quantum"
    err = np.linalg.norm(slam.state.cur_pose[:3].numpy() - seq.poses[6][:3])
    assert err < 0.3, f"recovered pose {err:.2f} m from truth"

    # ---- tracking resumes through the normal stream path ----
    for f in range(7, 12):
        slam.process_frame(*seq.images[f])
    res = slam.results()
    assert res["tracked_ok"][-4:].all(), "tracking did not resume"
    assert np.all(np.isfinite(res["trajectory"]))


# ---------------------------------------------------------------------------
# duplicate-landmark suppression, photometric degradation (faithful driver)
# ---------------------------------------------------------------------------

def test_duplicate_suppression():
    seq = synthetic.generate(num_frames=12, num_points=500, seed=3)
    out = {}
    for suppress in (False, True):
        # tests/test_dedup_landmarks.py's configuration
        slam = SlamSystem(seq.calib, port(
            jphoto.small_config(), ba_max_iters=8,
            suppress_duplicate_landmarks=suppress), device="cpu")
        for img_l, img_r in seq.images:
            slam.process_frame(img_l, img_r)
        out[suppress] = kf_ate(slam, seq)[0], int(slam.lm.valid.sum())
    (rmse_off, n_off), (rmse_on, n_on) = out[False], out[True]
    assert n_on < n_off, (n_on, n_off)        # fewer duplicate landmarks
    assert rmse_on < max(rmse_off * 1.5, 0.12)  # accuracy not degraded


def test_vo_survives_photometric_degradation():
    seq = synthetic.generate(num_frames=24, num_points=500, seed=3)
    images = synthetic.degrade(seq.images, seed=3)
    slam = SlamSystem(seq.calib, port(jphoto.small_config()), device="cpu")
    for img_l, img_r in images:
        slam.process_frame(img_l, img_r)
    rmse, n_kf = kf_ate(slam, seq)
    assert n_kf >= 3
    # clean-render bound is 0.08 m (test_e2e_vo); allow a modest hit
    assert rmse < 0.15, f"ATE {rmse:.3f} m under degradation"
    n_inl = [s["inliers"] for s in slam.stats if s["kind"] == "track"]
    assert np.median(n_inl) > 20
    ok = [s["ok"] for s in slam.stats[1:]]
    assert np.mean(ok) > 0.9, "tracking lost under degradation"
