"""The port's faithful driver (``pipeline/slam.SlamSystem``) against the
JAX package's, on the CPU.

- the standard drive, ``synthetic.generate(num_frames=24, num_points=500,
  seed=3)`` with tests/test_e2e_vo.py's ``small_config()``: frame 0's
  ``stereo_inliers`` and ``new_landmarks`` equal the JAX ``SlamSystem``'s
  (no random draw has happened yet), the ``info`` keys equal on every
  frame, keyframe ATE < 0.08 m and within 2x of the JAX driver's,
  full-trajectory ATE < 0.12 m (RANSAC draws differ between the packages,
  so runs are compared by outcome);
- a checkpoint written by the JAX package's ``checkpoint.save`` in the
  middle of that run loads into the port's ``SlamSystem``: state arrays
  equal, and the next frame gives the JAX run's ``info`` up to the draws
  (matches equal, inliers within 5, pose within 2 cm);
- ``tracking.retry_localize`` with the JAX package's draws injected:
  pose within 1e-4, inlier masks and counts equal;
- ``_loop_closure_step`` on tests/test_loop_closure.py's drifted circle
  of keyframes: detection, the PnP correction, verification with the
  identity-gain gate, the closure (the current keyframe lands on its true
  pose), the global-BA flag and the cooldown; a verification that fails
  is recorded and closes nothing; the closed-form solver finds no 3D-3D
  pairs there (both sides see the same landmarks) and closes nothing;
- the motion-gate retry loop, the teleport relocalization of
  tests/test_e2e_reloc.py (its bars), online vocabulary training with the
  back-fill, ``set_vocabulary``, the pending window BA's one-frame merge
  lag and its keyframe gate, window eviction, ``set_params`` /
  ``set_param`` of both drivers, ``debug_checks``, the capacity warnings,
  ``feature_fn``, ``run_global_ba_offline``, and what raises: a missing
  card and capacity fields; the settings that once raised as unported
  (free intrinsics, ``ba_device``, ``gba_mesh_devices``) take their branch.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_e2e_vo import small_config
from test_loop_closure import INTR, N_KF, drifted_map  # noqa: F401
from test_torch_loop import CAND, CUR, banked, to_port  # noqa: F401
from vslam_tpu.loop import vocabulary as jvocab
from vslam_tpu.pipeline import tracking as jtracking
from vslam_tpu.pipeline.slam import SlamSystem as JaxSlamSystem
from vslam_tpu.solvers import pnp as jpnp
from vslam_tpu.utils import checkpoint as jcheckpoint
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core.state import LandmarkState
from vslam_tpu_torch.eval import ate
from vslam_tpu_torch.frontend.features import Features, extract_features
from vslam_tpu_torch.geometry import lie
from vslam_tpu_torch.loop import vocabulary as tvocab
from vslam_tpu_torch.ops import describe as tdescribe
from vslam_tpu_torch.pipeline import slam as slam_mod
from vslam_tpu_torch.pipeline import tracking as ttracking
from vslam_tpu_torch.pipeline.slam import SlamSystem
from vslam_tpu_torch.pipeline.streaming import StreamingVO
from vslam_tpu_torch.utils import checkpoint as tcheckpoint
from vslam_tpu_torch.utils import debug as tdebug

CKPT_FRAME = 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(x):
    return torch.as_tensor(np.array(x))


def port_config(**kw):
    """tests/test_e2e_vo.py's small_config as the port's SlamConfig."""
    return SlamConfig(**{**dataclasses.asdict(small_config()), **kw})


def kf_ate(slam, seq):
    fids, pos, _ = slam.keyframe_trajectory()
    return ate.align_svd(pos, seq.poses[fids, :3])[2]


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(num_frames=24, num_points=500, seed=3)


@pytest.fixture(scope="module")
def jax_run(seq, tmp_path_factory):
    """The JAX SlamSystem on the standard drive; before frame CKPT_FRAME a
    vocabulary is installed and a checkpoint written."""
    slam = JaxSlamSystem(seq.calib, small_config())
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "ckpt")
    infos = []
    for f, (img_l, img_r) in enumerate(seq.images):
        if f == CKPT_FRAME:
            slam.set_vocabulary(jvocab.synthetic_vocab(k=4, depth=3, seed=1))
            jcheckpoint.save(slam, ckpt)
        infos.append(slam.process_frame(img_l, img_r))
    return slam, infos, ckpt


@pytest.fixture(scope="module")
def port_run(seq):
    slam = SlamSystem(seq.calib, port_config(), device="cpu")
    infos = [slam.process_frame(*pair) for pair in seq.images]
    return slam, infos


def test_standard_drive_matches_jax_driver(port_run, jax_run, seq):
    slam, infos = port_run
    jslam, jinfos, _ = jax_run
    # frame 0: the bootstrap keyframe, before any random draw
    assert infos[0]["kind"] == jinfos[0]["kind"] == "keyframe"
    assert infos[0]["stereo_inliers"] == jinfos[0]["stereo_inliers"] > 40
    assert infos[0]["new_landmarks"] == jinfos[0]["new_landmarks"] > 40
    for a, b in zip(infos, jinfos):
        if a["kind"] == b["kind"]:
            assert set(a) == set(b), (a, b)
    keys = {i["kind"]: set(i) for i in infos}
    jkeys = {i["kind"]: set(i) for i in jinfos}
    assert keys == jkeys and set(keys) == {"keyframe", "track"}
    assert all(i["ok"] for i in infos[1:])
    assert all(type(v) in (int, bool, str) for i in infos
               for v in i.values())
    rmse = kf_ate(slam, seq)
    jf, jp, _ = jslam.keyframe_trajectory()
    rmse_j = ate.align_svd(jp, seq.poses[jf, :3])[2]
    assert rmse < 0.08, rmse
    assert rmse < max(2.0 * rmse_j, 0.05), (rmse, rmse_j)
    fa, fb = jf, slam.keyframe_trajectory()[0]
    assert len(fb) >= 3 and abs(len(fa) - len(fb)) <= 1, (fa, fb)
    inl = [i["inliers"] for i in infos if i["kind"] == "track"]
    assert np.median(inl) > 30


def test_standard_drive_full_trajectory_and_bookkeeping(port_run, seq):
    slam, infos = port_run
    est = np.stack(slam.trajectory)[:, :3]
    assert est.shape == (24, 3)
    assert ate.align_svd(est, seq.poses[:, :3])[2] < 0.12
    assert slam.frame == 24 and len(slam.stats) == 24
    assert [i["frame"] for i in infos] == list(range(24))
    kf_frames = [i["frame"] for i in infos if i["kind"] == "keyframe"]
    assert slam.slot_of_frame == {f: s for s, f in enumerate(kf_frames)}
    assert slam.kf_window == kf_frames[-slam.cfg.max_num_kfs:]
    # covisibility is symmetric and above the threshold
    assert slam.covis and all(
        slam.covis[b][a] == w >= slam.cfg.num_cov_threshold
        for a, d in slam.covis.items() for b, w in d.items())
    # no place recognition without loop closure / relocalization
    assert slam.voc is None and not slam.detector.db.bow_of
    summary = slam.timer.summary()
    assert summary["keyframe"]["count"] == len(kf_frames)
    assert summary["track"]["count"] == 24 - len(kf_frames)


def test_pending_window_ba_merges_at_the_next_frame(seq):
    """The window BA is solved at the keyframe step, held, and merged at the
    start of the next frame; no keyframe is requested while one is held."""
    slam = SlamSystem(seq.calib, port_config(new_kf_min_inliers=10 ** 6),
                      device="cpu")
    info = slam.process_frame(*seq.images[0])
    assert info["kind"] == "keyframe" and slam._pending_ba is not None
    wp, _, points, _ = slam._pending_ba
    pos_before = slam.lm.pos.clone()
    # every tracking frame wants a keyframe (inliers < 10**6); the merge at
    # the start of the frame lets the request through
    info = slam.process_frame(*seq.images[1])
    assert info["kind"] == "track" and slam._pending_ba is None
    assert slam.take_keyframe
    sel = wp.sel_lm[wp.sel_lm_valid].long()
    assert len(sel) > 40
    np.testing.assert_array_equal(slam.lm.pos[sel].numpy(),
                                  points[wp.sel_lm_valid].numpy())
    assert not torch.equal(slam.lm.pos, pos_before)
    info = slam.process_frame(*seq.images[2])
    assert info["kind"] == "keyframe" and slam._pending_ba is not None
    # the gate itself: a tracking step while a BA is held asks for nothing
    img = slam._image(seq.images[3][0])
    slam._tracking_step(img)
    assert not slam.take_keyframe
    assert slam._merge_pending_ba() and not slam._merge_pending_ba()
    slam._tracking_step(img)
    assert slam.take_keyframe
    # keyframe_trajectory settles what is held
    slam.process_frame(*seq.images[4])
    assert slam._pending_ba is not None
    slam.keyframe_trajectory()
    assert slam._pending_ba is None


def test_jax_checkpoint_loads_into_the_port(jax_run, seq):
    jslam, jinfos, ckpt = jax_run
    slam = tcheckpoint.load(
        SlamSystem(seq.calib, port_config(), device="cpu"), ckpt,
        device="cpu")
    data = np.load(ckpt + ".npz")
    for prefix, tree in (("lm", slam.lm), ("kf", slam.kf),
                         ("track", slam.track)):
        arrays = interop.to_arrays(tree)
        assert {f"{prefix}.{k}" for k in arrays} <= set(data.files)
        for name, value in arrays.items():
            np.testing.assert_array_equal(value, data[f"{prefix}.{name}"],
                                          err_msg=f"{prefix}.{name}")
    assert slam.frame == CKPT_FRAME and len(slam.trajectory) == CKPT_FRAME
    assert slam.stats == jinfos[:CKPT_FRAME]
    assert slam.voc.num_words == 64 and slam.device_voc is not None
    np.testing.assert_array_equal(slam.voc.node_desc, data["voc.node_desc"])
    assert len(slam.detector.db.bow_of) == len(slam.slot_of_frame) >= 2
    # the reference's PRNG key has no torch meaning: seeded from cfg.seed
    fresh = torch.Generator().manual_seed(slam.cfg.seed)
    assert torch.equal(slam.generator.get_state(), fresh.get_state())
    # one more frame, against the JAX run's
    info = slam.process_frame(*seq.images[CKPT_FRAME])
    want = jinfos[CKPT_FRAME]
    assert info["kind"] == want["kind"] and info["ok"] and want["ok"]
    assert info["matches"] == want["matches"]
    assert abs(info["inliers"] - want["inliers"]) <= 5
    np.testing.assert_allclose(slam.trajectory[-1],
                               jslam.trajectory[CKPT_FRAME], atol=2e-2)
    for f in range(CKPT_FRAME + 1, 24):
        slam.process_frame(*seq.images[f])
    assert kf_ate(slam, seq) < 0.08


def test_checkpoint_load_needs_the_card(jax_run, seq):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    slam = SlamSystem(seq.calib, port_config(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcheckpoint.load(slam, jax_run[2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlamSystem(seq.calib, port_config())


@pytest.mark.parametrize("seed", [0, 5])
def test_retry_localize_matches_jax_with_injected_draws(jax_run, seed):
    jslam = jax_run[0]
    res_j, lm_j = jslam._last_res, jslam.lm
    assert int(res_j.num_matches) > 30
    pred = np.asarray(jslam.track.current_pose)
    vel = np.asarray(jslam.track.vel)
    key = jax.random.PRNGKey(seed)
    kw = dict(cam_name="pinhole", pnp_threshold=jslam.pnp_threshold,
              num_hypotheses=64, min_matches=10)
    out_j = jtracking.retry_localize(
        key, res_j, lm_j, jnp.asarray(pred), jnp.asarray(pred),
        jnp.asarray(vel), jslam.intr0, **kw)
    idx = np.asarray(jpnp._sample_minimal(key, res_j.match_lm >= 0, 64, 6))
    res_t = interop.from_arrays(ttracking.TrackResult, res_j._asdict(), "cpu")
    lm_t = interop.from_arrays(LandmarkState, lm_j._asdict(), "cpu")
    out_t = ttracking.retry_localize(
        res_t, lm_t, tt(pred), tt(pred), tt(vel), tt(jslam.intr0),
        sample_idx=tt(idx), **kw)
    assert bool(out_t.pnp_ok) and bool(out_j.pnp_ok)
    np.testing.assert_allclose(out_t.T_w_c.numpy(), np.asarray(out_j.T_w_c),
                               atol=1e-4)
    np.testing.assert_array_equal(out_t.inlier.numpy(),
                                  np.asarray(out_j.inlier))
    assert int(out_t.num_inliers) == int(out_j.num_inliers) > 20
    np.testing.assert_allclose(float(out_t.motion_err),
                               float(out_j.motion_err), atol=1e-3)
    # the match set is carried through untouched
    assert out_t.feats is res_t.feats and out_t.match_lm is res_t.match_lm
    # too few matches: the predicted pose comes back, the gate still reads
    few = ttracking.retry_localize(
        res_t, lm_t, tt(pred), tt(pred), tt(vel), tt(jslam.intr0),
        sample_idx=tt(idx), **{**kw, "min_matches": 10 ** 6})
    assert not bool(few.pnp_ok) and int(few.num_inliers) == 0
    np.testing.assert_array_equal(few.T_w_c.numpy(), pred)
    assert not few.inlier.any()


def reloc_config(**kw):
    """tests/test_e2e_reloc.py's configuration."""
    return SlamConfig(**{**dict(
        num_features=400, ransac_hypotheses=128, max_landmarks=8192,
        max_keyframes=64, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=8,
        enable_relocalization=True, enable_loop_closure=False,
        new_kf_min_inliers=40, vocab_depth=3, quality_level=0.001,
        motion_threshold=1000.0), **kw})


@pytest.fixture(scope="module")
def reloc_run():
    seq = synthetic.generate(num_frames=16, num_points=500, seed=3)
    slam = SlamSystem(seq.calib, reloc_config(), device="cpu")
    # the fourth keyframe (frame 12) fills the training pool
    for f in range(14):
        slam.process_frame(*seq.images[f])
    return seq, slam


def test_online_vocabulary_and_backfill(reloc_run):
    """The vocabulary is trained from the first keyframes' descriptors and
    the keyframes seen before it existed are back-filled into the
    database."""
    _, slam = reloc_run
    assert slam.device_voc is not None and slam.voc.num_words > 8
    assert slam._vocab_pool == []
    n_kf = len(slam.slot_of_frame)
    assert n_kf >= 3 and len(slam.detector.db.bow_of) == n_kf
    assert sorted(slam.detector.db.bow_of) == sorted(
        slam.slot_of_frame.values())
    assert all(i["ok"] for i in slam.stats[1:])


def test_relocalization_recovers_from_teleport(reloc_run):
    seq, slam = reloc_run
    bad = torch.tensor([50.0, 20.0, -30.0, 0, 0, 0, 1.0])
    slam.track = slam.track.replace(current_pose=bad, last_pose=bad,
                                    vel=lie.identity_pose())
    slam.tracking_ok = False
    n_before = len(slam.reloc_events)
    info = slam.process_frame(*seq.images[6])
    assert info["ok"], f"relocalization failed: {info}"
    assert slam.reloc_events[n_before:] == [(14, True)]
    err = np.linalg.norm(slam.track.current_pose.numpy()[:3]
                         - seq.poses[6][:3])
    assert err < 0.3, f"recovered pose {err:.2f} m from truth"
    assert slam._lost_count == 0 and slam.tracking_ok


def test_motion_gate_retries_then_loses_the_frame(seq):
    """With relocalization on, a pose that fails the motion gate is redrawn
    ``track_max_retries`` times on the same matches, then the frame is
    lost: the pose coasts and the velocity decays."""
    cfg = reloc_config(new_kf_min_inliers=60, quality_level=0.01,
                       track_max_retries=3)
    slam = SlamSystem(seq.calib, cfg, device="cpu")
    for f in range(6):
        slam.process_frame(*seq.images[f])
    calls = []
    real = ttracking.retry_localize

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    slam_mod.tracking.retry_localize = spy
    try:
        info_ok = slam.process_frame(*seq.images[6])
        assert info_ok["ok"] and not calls        # the gate holds: no retry
        slam.set_params(motion_threshold=0.0)     # nothing passes the gate
        prev = slam.track.current_pose.clone()
        vel = slam.track.vel.clone()
        was_ok = slam.tracking_ok
        info = slam.process_frame(*seq.images[7])
    finally:
        slam_mod.tracking.retry_localize = real
    assert len(calls) == 3
    assert not info["ok"] and info["inliers"] == 0 and info["matches"] > 30
    assert slam._lost_count == 1 and not slam.tracking_ok and was_ok
    # the lost pose is the constant-velocity coast
    np.testing.assert_allclose(slam.trajectory[-1],
                               lie.se3_mul(prev, vel).numpy(), atol=1e-6)
    # the velocity decays toward rest on a lost frame
    v_new = lie.se3_log(slam.track.vel)
    np.testing.assert_allclose(
        v_new.numpy(), cfg.vel_decay_factor * lie.se3_log(vel).numpy(),
        atol=1e-5)
    # no vocabulary yet (two keyframes): relocalization has nothing to ask
    assert slam.device_voc is None and slam.reloc_events == []
    # a lost frame asks for a keyframe (0 inliers) once no BA is held
    assert slam.take_keyframe


def test_set_vocabulary_backfills_and_loop_step_runs(seq):
    """A vocabulary installed mid-run back-fills the database; with loop
    closure on, each keyframe step queries and feeds the detector."""
    cfg = port_config(enable_loop_closure=True, enable_relocalization=True,
                      loop_closing_time_threshold=2)
    slam = SlamSystem(seq.calib, cfg, device="cpu")
    for f in range(8):
        slam.process_frame(*seq.images[f])
    pool = []
    for f in range(0, 24, 4):
        ft = extract_features(torch.as_tensor(seq.images[f][0]),
                              num_features=400)
        pool.append(ft.bits.numpy()[ft.valid.numpy()])
    voc = tvocab.train(np.concatenate(pool), k=6, depth=3, seed=0)
    tvocab.set_idf_weights(voc, pool)
    n_before = len(slam.slot_of_frame)
    slam.set_vocabulary(voc)
    assert slam.voc is voc
    assert len(slam.detector.db.bow_of) == n_before >= 2
    for f in range(8, 24):
        slam.process_frame(*seq.images[f])
    assert len(slam.detector.db.bow_of) == len(slam.slot_of_frame) > n_before
    assert all("loops_closed" in i for i in slam.stats
               if i["kind"] == "keyframe")
    # a forward sweep revisits nothing: whatever was proposed, the map holds
    assert kf_ate(slam, seq) < 0.08
    assert slam.gba_merges == len(slam.loop_edges) * int(
        cfg.enable_gba_after_loop)


def loop_system(banked_map, **kw):
    """A SlamSystem holding the drifted circle: every keyframe but the
    current one in the recognition database, the current one about to run
    its loop-closure step after two consistent detections."""
    kf, lm, _, _, covis = banked_map
    kt, lt = to_port(kf, lm)
    cfg = port_config(**{**dict(
        num_features=64, max_keyframes=16, max_landmarks=2048,
        lm_desc_bank=2, enable_loop_closure=True, enable_gba_after_loop=True,
        loop_closing_time_threshold=20, loop_verify_min_inliers=5), **kw})
    slam = SlamSystem(synthetic.make_calib(320, 240), cfg, device="cpu")
    slam.intr0 = slam.intr1 = tt(INTR)
    slam.kf, slam.lm = kt, lt
    slam.covis = {a: dict(d) for a, d in covis.items()}
    slam.slot_of_frame = {30 * i: i for i in range(N_KF - 1)}
    pool = [tdescribe.unpack_bits(kt.desc[i, 0]).numpy() for i in range(N_KF)]
    voc = tvocab.train(np.concatenate(pool), k=4, depth=3, seed=0)
    tvocab.set_idf_weights(voc, pool)
    slam.set_vocabulary(voc)
    assert sorted(slam.detector.db.bow_of) == list(range(N_KF - 1))
    slam.slot_of_frame[30 * CUR] = CUR
    slam.frame = 30 * CUR
    slam.detector.consistent_groups = [({CAND, 1}, cfg.num_consistency - 1)]
    feats = Features(corners=kt.corners[CUR, 0], angles=torch.zeros(64),
                     bits=tdescribe.unpack_bits(kt.desc[CUR, 0]),
                     valid=kt.kp_valid[CUR, 0])
    return slam, feats


def pose_error(pose, want):
    return float(lie.se3_log(lie.se3_mul(lie.se3_inv(tt(want)),
                                         pose)).abs().max())


def test_loop_closure_step_closes_the_drifted_circle(banked):  # noqa: F811
    true_poses, stored = banked[2], banked[3]
    slam, feats = loop_system(banked)
    assert pose_error(slam.kf.pose_l[CUR], true_poses[CUR]) > 0.2
    n = slam._loop_closure_step(CUR, feats, slam.covis[CUR])
    assert n == 1 and slam.last_loop_candidates == [CAND]
    assert slam.loop_edges == [(CUR, CAND)] and slam.rejected_loops == []
    assert slam.pose_graph_done and slam._last_closure_frame == 30 * CUR
    assert CUR in slam.detector.db.bow_of
    # the current keyframe lands on its true pose; the candidate stays
    assert pose_error(slam.kf.pose_l[CUR], true_poses[CUR]) < 1e-3
    np.testing.assert_array_equal(slam.kf.pose_l[CAND].numpy(), stored[CAND])
    assert bool(torch.isfinite(slam.kf.pose_l).all()
                & torch.isfinite(slam.lm.pos).all())
    # the same revisit keeps detecting: the cooldown closes nothing more
    slam.frame += 30
    slam.detector.consistent_groups = [({CAND, 1}, 2)]
    assert slam._loop_closure_step(CUR, feats, slam.covis[CUR]) == 0
    assert len(slam.loop_edges) == 1


@pytest.mark.parametrize("kw,rejected", [
    (dict(loop_verify_min_inliers=30), True),       # ~10 landmarks in view
    (dict(loop_verify_min_gain=50.0), True),        # the identity-gain gate
    (dict(sim3_solver="horn"), False),              # no 3D-3D pairs here
    (dict(loop_closing_time_threshold=10 ** 4), False)])
def test_loop_closure_step_refusals(banked, kw, rejected):  # noqa: F811
    slam, feats = loop_system(banked, **kw)
    before = slam.kf.pose_l.clone()
    assert slam._loop_closure_step(CUR, feats, slam.covis[CUR]) == 0
    assert slam.last_loop_candidates == [CAND] and slam.loop_edges == []
    assert not slam.pose_graph_done
    assert torch.equal(slam.kf.pose_l, before)
    assert len(slam.rejected_loops) == int(rejected)
    if rejected:
        slot, cand, n_inl, n_vis = slam.rejected_loops[0]
        assert (slot, cand) == (CUR, CAND) and 5 <= n_inl <= n_vis


def test_loop_closure_step_without_loop_closure_feeds_the_database(
        banked):  # noqa: F811
    """Relocalization alone still needs the database: the step inserts the
    keyframe's words and detects nothing."""
    slam, feats = loop_system(banked, enable_loop_closure=False,
                              enable_relocalization=True)
    assert slam._loop_closure_step(CUR, feats, slam.covis[CUR]) == 0
    assert CUR in slam.detector.db.bow_of and slam.last_loop_candidates == []


def test_driver_merges_the_global_ba_at_the_next_frame():
    """tests/test_gba_async.py::test_driver_merges_async_gba: the flag a
    closure sets makes the next keyframe step solve a global BA on a
    snapshot; it is held and skip-merged at the start of the next frame,
    tracking alive throughout."""
    seq = synthetic.generate(num_frames=16, num_points=500, seed=3)
    slam = SlamSystem(seq.calib, port_config(
        ba_max_iters=8, new_kf_min_inliers=65, quality_level=0.001,
        max_num_kfs=2), device="cpu")
    for f in range(8):
        slam.process_frame(*seq.images[f])
    slam.pose_graph_done = True     # a closure just corrected the graph
    slam.take_keyframe = True
    info = slam.process_frame(*seq.images[8])
    assert info["kind"] == "keyframe" and not slam.pose_graph_done
    pending = slam._pending_gba
    assert pending is not None and slam.gba_merges == 0
    assert pending.n_kf == len(slam.slot_of_frame)
    assert float(pending.stats["final_cost"]) <= float(
        pending.stats["initial_cost"])
    # this keyframe's window BA was merged before the snapshot was taken
    assert slam._pending_ba is None
    slam.process_frame(*seq.images[9])
    assert slam._pending_gba is None and slam.gba_merges == 1
    for f in range(10, 16):
        slam.process_frame(*seq.images[f])
    _, est_pos, _ = slam.keyframe_trajectory()
    assert np.isfinite(est_pos).all() and slam.gba_merges == 1
    assert sum(bool(i["ok"]) for i in slam.stats) >= 12
    assert kf_ate(slam, seq) < 0.08


def test_window_eviction_and_offline_global_ba(seq):
    slam = SlamSystem(seq.calib, port_config(max_num_kfs=2,
                                             new_kf_min_inliers=65,
                                             quality_level=0.001),
                      device="cpu")
    for pair in seq.images[:16]:
        slam.process_frame(*pair)
    n_kf = len(slam.slot_of_frame)
    assert n_kf >= 4 and len(slam.kf_window) == 2
    active = slam.kf.active.numpy()
    assert active.sum() == 2
    assert sorted(np.flatnonzero(active)) == sorted(
        slam.slot_of_frame[f] for f in slam.kf_window)
    before = kf_ate(slam, seq)
    stats = slam.run_global_ba_offline()
    assert float(stats["final_cost"]) <= float(stats["initial_cost"])
    assert slam._pending_ba is None and slam._pending_gba is None
    assert kf_ate(slam, seq) < max(1.5 * before, 0.08)


def test_set_params_rederives_pnp_threshold(seq):
    slam = SlamSystem(seq.calib, port_config(), device="cpu")
    slam.set_params(pnp_inlier_thresh_px=5.0, match_max_dist=60)
    assert slam.cfg.match_max_dist == 60
    assert slam.pnp_threshold == pytest.approx(
        1.0 - math.cos(math.atan(5.0 / 500.0)))
    slam.set_param("motion_threshold", 0.25)
    assert slam.cfg.motion_threshold == 0.25
    with pytest.raises(AttributeError, match="unknown config field"):
        slam.set_params(no_such_field=1)
    for name in slam_mod.CAPACITY_FIELDS:
        with pytest.raises(ValueError, match="sizes the state's buffers"):
            slam.set_param(name, 128)
    # the settings that once raised as unported are plain config fields now
    for name, value in (("ba_optimize_intrinsics", True), ("ba_device", 1),
                        ("gba_mesh_devices", 4)):
        slam.set_param(name, value)
        assert getattr(slam.cfg, name) == value


@pytest.mark.parametrize("field,value", [("ba_optimize_intrinsics", True),
                                         ("ba_device", 1),
                                         ("gba_mesh_devices", 4)])
def test_unported_settings_raise_and_name_roadmap(seq, field, value,
                                                  monkeypatch):
    """No setting raises as unported any more: each is accepted and takes
    its branch on the keyframe step. ``ba_optimize_intrinsics`` calls the
    free-intrinsics solver and holds its [2, 8] result for the merge;
    ``ba_device`` solves where ``SlamSystem.ba_device()`` says (the system's
    own device on the CPU); ``gba_mesh_devices`` above the process's device
    count gives no mesh (the documented fall-back), and with that many
    devices (the list patched to four entries of the CPU) a four-way mesh.
    The overlay and report hooks stay absent."""
    from vslam_tpu_torch.parallel import mesh as mesh_mod
    from vslam_tpu_torch.pipeline import ba_global
    from vslam_tpu_torch.solvers import ba as ba_mod

    calls = []
    for fn in ("solve_ba_schur", "solve_ba_schur_intrinsics"):
        real = getattr(ba_mod, fn)
        monkeypatch.setattr(ba_mod, fn, lambda *a, _r=real, _n=fn, **k: (
            calls.append((_n, a[0].poses.device)), _r(*a, **k))[1])
    slam = SlamSystem(seq.calib, port_config(**{field: value}), device="cpu")
    info = slam.process_frame(*seq.images[0])
    assert info["kind"] == "keyframe" and len(calls) == 1
    wp, poses, points, intr2 = slam._pending_ba
    if field == "ba_optimize_intrinsics":
        assert calls[0][0] == "solve_ba_schur_intrinsics"
        assert intr2.shape == (2, 8) and torch.isfinite(intr2).all()
    else:
        assert calls[0][0] == "solve_ba_schur" and intr2 is None
    assert slam.ba_device() == torch.device("cpu") == calls[0][1]
    if field == "gba_mesh_devices":
        assert ba_global.gba_mesh(slam.cfg) is None
        monkeypatch.setattr(mesh_mod, "available_devices",
                            lambda: [torch.device("cpu")] * 4)
        mesh = ba_global.gba_mesh(slam.cfg)
        assert mesh.shape == {"data": 4}
    slam.process_frame(*seq.images[1])
    assert slam._pending_ba is None
    # the reporting hooks, once unported, are there (test_torch_reporting)
    assert callable(SlamSystem.render_overlay)
    assert callable(SlamSystem.reprojection_report)


def test_ba_optimize_intrinsics_merges_refined_intrinsics(seq, tmp_path):
    """tests/test_ba.py::test_e2e_ba_optimize_intrinsics_flag's run and
    bars: tracking holds from frame 3 on, the merged intrinsics are finite
    and fx stays within 20 px; they differ from the calibration's (the
    merge happened) and a checkpoint keeps them."""
    slam = SlamSystem(seq.calib, port_config(ba_optimize_intrinsics=True),
                      device="cpu")
    infos = [slam.process_frame(*pair) for pair in seq.images[:10]]
    assert all(i["ok"] for i in infos[3:]), [i["ok"] for i in infos]
    intr0, intr1 = slam.intr0.numpy(), slam.intr1.numpy()
    assert np.isfinite(intr0).all() and np.isfinite(intr1).all()
    assert abs(intr0[0] - seq.calib.intrinsics[0][0]) < 20.0, intr0
    assert not np.array_equal(intr0, np.asarray(seq.calib.intrinsics[0],
                                                np.float32))
    path = str(tmp_path / "ckpt")
    tcheckpoint.save(slam, path)
    back = tcheckpoint.load(
        SlamSystem(seq.calib, port_config(ba_optimize_intrinsics=True),
                   device="cpu"), path, device="cpu")
    assert torch.equal(back.intr0, slam.intr0)
    assert torch.equal(back.intr1, slam.intr1)
    assert not np.array_equal(back.intr0.numpy(),
                              np.asarray(seq.calib.intrinsics[0], np.float32))


def test_ba_device_matches_single_device(seq):
    """tests/test_multichip.py::test_ba_on_second_device_matches_single_
    device's bar (keyframe ATE < 0.15 m over 12 frames either way); the
    port's solve is finished when it is held, so on one device the two runs
    are the same run: every ``info`` and the poses are equal."""
    runs = []
    for ba_device in (None, 1):
        slam = SlamSystem(seq.calib, port_config(ba_device=ba_device),
                          device="cpu")
        infos = [slam.process_frame(*pair) for pair in seq.images[:12]]
        assert kf_ate(slam, seq) < 0.15
        runs.append((infos, np.stack(slam.trajectory)))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_streaming_set_param(seq):
    """Every DEVICE_TUNABLE and HOST_TUNABLE name sets the config (and the
    gate scalars the step reads); anything else raises ValueError as the
    reference does."""
    from vslam_tpu_torch.config import (DEVICE_TUNABLE, DEVICE_TUNE_TRANSFORM,
                                        HOST_TUNABLE)

    vo = StreamingVO(seq.calib, port_config(), max_frames=8, device="cpu")
    for name in DEVICE_TUNABLE:
        value = type(getattr(vo.cfg, name))(3)
        vo.set_param(name, value)
        assert getattr(vo.cfg, name) == value
        xf = DEVICE_TUNE_TRANSFORM.get(name, lambda v: v)
        assert vo.tune[name] == float(np.float32(xf(3.0)))
    assert vo.pnp_threshold == pytest.approx(
        1.0 - math.cos(math.atan(3.0 / 500.0)))
    for name in HOST_TUNABLE:
        vo.set_param(name, getattr(vo.cfg, name))
    vo.set_param("loop_cooldown_frames", 7)
    assert vo.cfg.loop_cooldown_frames == 7
    for name in ("num_features", "max_landmarks", "no_such_field"):
        with pytest.raises(ValueError, match="not live-tunable"):
            vo.set_param(name, 1)
    # a changed gate takes effect on the next frame
    vo2 = StreamingVO(seq.calib, port_config(), max_frames=8, device="cpu")
    vo2.run(seq.images[:3])
    vo2.set_param("match_max_dist", 0)      # no descriptor can match
    vo2.process_frame(*seq.images[3])
    res = vo2.results()
    assert res["tracked_ok"][2] and not res["tracked_ok"][3]


def test_debug_checks_and_capacity_warnings(seq, capsys):
    slam = SlamSystem(seq.calib, port_config(debug_checks=True,
                                             max_keyframes=4,
                                             max_landmarks=128,
                                             new_kf_min_inliers=10 ** 6),
                      device="cpu")
    for pair in seq.images[:8]:
        slam.process_frame(*pair)       # finite throughout
    err = capsys.readouterr().err
    assert "keyframe capacity nearly exhausted" in err
    assert "landmark capacity nearly exhausted" in err
    assert err.count("keyframe capacity") == 1      # warned once
    assert tdebug.find_nonfinite(slam.lm) == {}
    slam.lm = slam.lm.replace(pos=slam.lm.pos.clone().index_fill_(
        0, torch.tensor([3]), float("nan")))
    assert tdebug.find_nonfinite(slam.lm) == {"pos": 3}
    with pytest.raises(FloatingPointError, match="lm.pos"):
        tdebug.assert_finite_state(slam)
    with pytest.raises(FloatingPointError, match="non-finite SLAM state"):
        slam.process_frame(*seq.images[8])


def test_textureless_frames_do_not_crash(seq):
    """The verify probe: flat images give no features; every frame is lost
    and nothing breaks."""
    slam = SlamSystem(seq.calib, port_config(), device="cpu")
    flat = np.full_like(seq.images[0][0], 100)
    for _ in range(4):
        info = slam.process_frame(flat, flat)
        assert info["matches"] == 0 and not info["ok"]
    assert np.isfinite(np.stack(slam.trajectory)).all()


def test_feature_fn_hook_replaces_the_extraction(seq):
    calls = []

    def feature_fn(img):
        calls.append(tuple(img.shape))
        return extract_features(img, num_features=400)

    slam = SlamSystem(seq.calib, port_config(), feature_fn=feature_fn,
                      device="cpu")
    plain = SlamSystem(seq.calib, port_config(), device="cpu")
    for pair in seq.images[:4]:
        a, b = slam.process_frame(*pair), plain.process_frame(*pair)
        assert a == b
    # left image on every frame, right image on keyframes
    n_kf = sum(i["kind"] == "keyframe" for i in slam.stats)
    assert len(calls) == 4 + n_kf and set(calls) == {(240, 320)}
