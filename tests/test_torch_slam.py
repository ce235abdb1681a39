"""The port's StreamingSLAM driver on the CPU.

- it requires a vocabulary, runs on the card unless told otherwise,
  accepts both Sim(3) solvers and refuses a sharded global BA;
- VO mode ignores the place-recognition state (the port of
  tests/test_streaming_slam.py::test_streaming_vo_ignores_bow_state);
- a short run on synthetic.generate(num_frames=24, num_points=500, seed=3)
  with tests/test_streaming.py's small_config and a vocabulary trained
  with the port's ``train`` on the port's features: one keyframe event per
  keyframe, whose words equal the JAX package's ``_descend`` of the stored
  keyframe descriptors, a detector database of every keyframe, and
  keyframe ATE within the VO bounds of tests/test_torch_streaming.py
  (< 0.08 m, within 2x of the port's VO driver on the same frames);
- lost frames (noise images, or a tracker turned off its pose): the loss
  log is read after every frame, the poll that sees two lost frames
  attempts relocalization and enters lost mode, which polls after every
  frame until tracking is back; relocalization recovers the turned
  tracker against the map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_streaming import small_config
from test_streaming_slam import pano_config
from vslam_tpu.loop import vocabulary as jvocab
from vslam_tpu_torch import synthetic
from vslam_tpu_torch.eval import ate
from vslam_tpu_torch.frontend.features import extract_features
from vslam_tpu_torch.geometry import lie
from vslam_tpu_torch.loop import vocabulary as tvocab
from vslam_tpu_torch.ops import describe
from vslam_tpu_torch.pipeline.streaming import StreamingSLAM, StreamingVO
from vslam_tpu_torch.synthetic_pano import generate_pano_loop


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    seq = synthetic.generate(num_frames=24, num_points=500, seed=3)
    pool = []
    for f in range(0, 24, 3):
        ft = extract_features(torch.as_tensor(seq.images[f][0]),
                              num_features=400)
        pool.append(ft.bits.numpy()[ft.valid.numpy()])
    voc = tvocab.train(np.concatenate(pool), k=6, depth=3, seed=0)
    tvocab.set_idf_weights(voc, pool)
    return seq, voc


def slam_config():
    cfg = small_config()
    cfg.enable_loop_closure = True
    cfg.enable_relocalization = True
    cfg.enable_gba_after_loop = True
    return cfg


def kf_ate(driver, seq):
    fids, pos, _ = driver.keyframe_trajectory()
    return ate.align_svd(pos, seq.poses[fids, :3])[2]


@pytest.fixture(scope="module")
def slam_run(world):
    seq, voc = world
    slam = StreamingSLAM(seq.calib, slam_config(), voc, max_frames=32,
                         poll_every=8, device="cpu")
    slam.run(seq.images)
    return slam


def test_streaming_slam_requires_vocabulary(world):
    seq, _ = world
    with pytest.raises(ValueError, match="vocabulary"):
        StreamingSLAM(seq.calib, slam_config(), None, device="cpu")


def test_streaming_slam_unported_options_raise(world):
    seq, voc = world
    cfg = slam_config()
    cfg.sim3_solver = "horn"    # the closed-form solver is ported
    assert StreamingSLAM(seq.calib, cfg, voc,
                         device="cpu").cfg.sim3_solver == "horn"
    cfg = slam_config()
    cfg.gba_mesh_devices = 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamingSLAM(seq.calib, cfg, voc, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamingSLAM(seq.calib, slam_config(), voc)


def test_streaming_vo_ignores_bow_state():
    """VO mode keeps working with the extended state (no vocabulary, no
    stored features) on the pano world."""
    seq = generate_pano_loop(num_frames=20, revolutions=1.75 * 20 / 256,
                             seed=2)
    cfg = pano_config()
    cfg.enable_loop_closure = False
    vo = StreamingVO(seq.calib, cfg, max_frames=32, device="cpu")
    vo.run(seq.images[:20])
    res = vo.results()
    assert res["frames"] == 20
    assert res["tracked_ok"][3:].all()
    assert vo.events == [] and vo.state.cur_bits is None


def test_keyframe_events_carry_jax_words(slam_run, world):
    seq, voc = world
    slam = slam_run
    res = slam.results()
    kf_frames = np.flatnonzero(res["is_keyframe"])
    assert len(slam.events) == len(kf_frames) >= 3
    assert [e.frame for e in slam.events] == kf_frames.tolist()
    kf = slam.state.kf
    for e in slam.events:
        slot = int(e.slot)
        assert int(kf.frame_id[slot]) == e.frame
        bits = describe.unpack_bits(kf.desc[slot, 0])
        valid = kf.kp_valid[slot, 0]
        want = np.asarray(jvocab._descend(
            jnp.asarray(voc.node_desc), jnp.asarray(voc.children),
            jnp.asarray(voc.word_of_node), jnp.asarray(bits.numpy()),
            jnp.asarray(valid.numpy()), voc.depth))
        np.testing.assert_array_equal(e.words.numpy(), want)
        assert (e.words.numpy() >= 0).sum() > 100
    # every keyframe reached the recognition database and the covisibility
    # graph, and slots map back to their frames
    assert sorted(slam.detector.db.bow_of) == sorted(
        int(e.slot) for e in slam.events)
    assert slam.frame_of_slot == {int(e.slot): e.frame for e in slam.events}
    assert any(slam.covis_host.values())


def test_slam_run_within_vo_bounds(slam_run, world):
    seq, _ = world
    res = slam_run.results()
    assert res["frames"] == len(seq.images)
    assert res["tracked_ok"][2:].all()
    vo = StreamingVO(seq.calib, small_config(), max_frames=32, device="cpu")
    vo.run(seq.images)
    rmse_slam, rmse_vo = kf_ate(slam_run, seq), kf_ate(vo, seq)
    assert rmse_slam < 0.08, rmse_slam
    assert rmse_slam < max(2.0 * rmse_vo, 0.05), (rmse_slam, rmse_vo)
    # no revisit on this short path: nothing closes, nothing relocalizes
    assert slam_run.loop_edges == [] and slam_run.reloc_events == []
    assert slam_run.gba_merges == 0


@pytest.mark.parametrize("loss", ["noise", "yaw"])
def test_lost_mode_and_relocalization(world, loss):
    """Tracking lost from frame 12: the loss log is read after every frame,
    so the poll after frame 13 (the newest two frames lost) attempts
    relocalization and enters lost mode (a poll after every frame) until
    tracking is back.

    ``noise``: frames 12-15 are noise images; the attempt has nothing to
    recognize and fails, and tracking recovers on its own at frame 16.
    ``yaw``: the tracker pose is turned 0.3 rad after frame 11, so the real
    frames that follow fail to track; relocalization against the map
    recovers the pose from frame 13's features, and frame 14 tracks."""
    seq, voc = world
    frames = list(seq.images)
    if loss == "noise":
        rng = np.random.RandomState(0)
        for i in range(12, 16):
            frames[i] = tuple(rng.randint(0, 256, frames[0][0].shape)
                              .astype(np.uint8) for _ in range(2))
    slam = StreamingSLAM(seq.calib, slam_config(), voc, max_frames=32,
                         poll_every=4, device="cpu")
    polls = []
    poll = slam.poll
    slam.poll = lambda: (polls.append(slam.state.frame), poll())[1]
    slam.run(frames[:12])
    if loss == "yaw":
        turn = lie.se3_exp(torch.tensor([0, 0, 0, 0, 0.3, 0.0]))
        st = slam.state
        slam.state = st.replace(cur_pose=lie.se3_mul(st.cur_pose, turn),
                                last_pose=lie.se3_mul(st.last_pose, turn))
    slam.run(frames[12:])
    res = slam.results()
    back = 16 if loss == "noise" else 14
    assert not res["tracked_ok"][12:back].any()
    assert res["tracked_ok"][back:].all()
    assert not res["is_keyframe"][12:back].any()
    # scheduled polls every 4 frames (and at the end of each run call), the
    # poll that sees the loss at frame 14, lost-mode polls until tracking
    # is back
    lost_mode = [15, 16, 17] if loss == "noise" else [15, 16]
    assert polls == [4, 8, 12, 12, 14, *lost_mode, 20, 24, 24]
    assert [f for f, _ in slam.reloc_events] == [14]
    (_, ok), = slam.reloc_events
    diag = slam.reloc_diags[0]
    assert diag["frames_lost"] == 2 and diag["candidates"] > 0
    if loss == "noise":
        assert not ok and diag["best_n"] < 10
    else:
        assert ok and diag["best_n"] >= 10
        assert diag["best_gate_err"] <= diag["gate"]
    assert np.isfinite(res["trajectory"]).all()
    assert kf_ate(slam, seq) < 0.08
