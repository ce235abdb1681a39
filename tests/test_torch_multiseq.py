"""The port's multi-sequence path against the JAX package and against its
own single-sequence code, on the CPU at a small size (3 sequences of
320x240, 300 features).

Tolerances. Everything up to the matches is integer work or elementwise
float32 and must be equal: features, matches, candidates, counts. The pose
of a batched call agrees with the single-sequence call within 1e-4 and not
bit for bit: the PnP refinement's sums over matches are batched products
there (``torch.func.vmap``) and matrix products here, which add in another
order; the inlier count may then differ on a match at the threshold (by at
most 2). Against the JAX package: poses within 1e-3 after a whole lockstep
step (tracking 1e-4, then a window BA on ~1e-4-different inputs), inlier
counts within 5 (as tests/test_torch_faithful.py), map positions within
5e-3 relative plus 1e-3 m (float32 triangulation, as
tests/test_torch_streaming.py), every integer and boolean field equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_streaming import assert_same
from vslam_tpu import synthetic as jsynthetic  # noqa: F401 (same worlds)
from vslam_tpu.config import SlamConfig as JaxConfig
from vslam_tpu.parallel import multiseq_runner as jms
from vslam_tpu.pipeline import tracking as jtrack
from vslam_tpu.solvers import pnp as jpnp
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.eval import ate
from vslam_tpu_torch.parallel import multiseq, multiseq_runner as tms
from vslam_tpu_torch.parallel.mesh import make_mesh
from vslam_tpu_torch.pipeline import tracking as ttrack

S, FRAMES = 3, 10
CFG = dict(num_features=300, ransac_hypotheses=64, max_landmarks=2048,
           max_keyframes=16, max_inview_landmarks=512, window_cams=8,
           window_points=512, window_obs=2048, ba_max_iters=6,
           enable_relocalization=False, enable_loop_closure=False,
           new_kf_min_inliers=60)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    # 24-frame worlds, of which the first FRAMES are run: a shorter world
    # moves faster per frame, and the lockstep step predicts no motion
    return [synthetic.generate(num_frames=24, num_points=500,
                               seed=3 + 8 * s) for s in range(S)]


def lockstep_frames(worlds, n=FRAMES):
    return [(np.stack([w.images[f][0] for w in worlds]),
             np.stack([w.images[f][1] for w in worlds])) for f in range(n)]


def host(tree):
    return jax.tree.map(np.asarray, tree)


def port_state(jstate):
    return interop.from_arrays(tms.MultiSeqState, host(jstate)._asdict(),
                               "cpu")


def jax_keys(jstate):
    """The per-sequence RANSAC keys the JAX step derives from its state."""
    _, k = jax.random.split(jnp.asarray(jstate.key))
    return jax.random.split(k, S)


def port_step(before, imgs_l, imgs_r, calib, cfg=None, compact=True):
    """One port step from the JAX state ``before`` (numpy), with the JAX
    step's own draws: the matches do not depend on the draws, so a first
    tracking call gives the match masks that the JAX sampler needs."""
    cfg = cfg or SlamConfig(**CFG)
    st = port_state(before)
    kw = step_kwargs(cfg, calib)
    first = ttrack.track_frame(
        torch.as_tensor(imgs_l), st.lm, st.pose, st.last_pose, st.vel,
        st.intr0, sample_idx=torch.zeros((S, cfg.ransac_hypotheses, 6),
                                         dtype=torch.int64), **kw)
    keys = jax_keys(before)
    idx = np.stack([np.asarray(jpnp._sample_minimal(
        keys[s], jnp.asarray(first.match_lm[s].numpy() >= 0),
        cfg.ransac_hypotheses, 6)) for s in range(S)])
    return tms.lockstep_step(
        st, torch.as_tensor(imgs_l), torch.as_tensor(imgs_r), cfg, "pinhole",
        calib.width, calib.height, kw["pnp_threshold"],
        compact_inserts=compact, sample_idx=torch.as_tensor(idx))


def step_kwargs(cfg, calib):
    import math

    return dict(
        cam_name="pinhole", num_features=cfg.num_features,
        inview_cap=cfg.max_inview_landmarks, width=calib.width,
        height=calib.height, z_threshold=cfg.cam_z_threshold,
        match_max_dist_2d=cfg.match_max_dist_2d,
        match_threshold=cfg.match_max_dist, match_ratio=cfg.match_next_best,
        pnp_threshold=1.0 - math.cos(math.atan(
            cfg.pnp_inlier_thresh_px / 500.0)),
        num_hypotheses=cfg.ransac_hypotheses,
        min_matches=cfg.ransac_min_matches, quality_level=cfg.quality_level,
        min_distance=cfg.min_distance, rotate_features=cfg.rotate_features,
        num_octaves=cfg.num_octaves)


@pytest.fixture(scope="module")
def lockstep(worlds):
    """The JAX driver over FRAMES lockstep frames; per frame the state
    before and after (numpy) and the port's step from the same state."""
    jvo = jms.MultiSeqVO(worlds[0].calib, S, JaxConfig(**CFG), max_frames=16)
    frames = lockstep_frames(worlds)
    records = []
    for imgs_l, imgs_r in frames:
        before = host(jvo.state)       # the JAX step donates its state
        jvo.process_frames(imgs_l, imgs_r)
        after = host(jvo.state)
        new, info = port_step(before, imgs_l, imgs_r, worlds[0].calib)
        records.append((before, after, new, info))
    return jvo, records


def assert_state_matches(new, after):
    for name in ("take_kf", "last_kf_slot", "ba_pending", "log_kf"):
        np.testing.assert_array_equal(getattr(new, name).numpy(),
                                      getattr(after, name), err_msg=name)
    assert (new.ba_cursor, new.kf_cursor, new.frame) == (
        int(after.ba_cursor), int(after.kf_cursor), int(after.frame))
    np.testing.assert_allclose(new.pose.numpy(), after.pose, atol=1e-3)
    np.testing.assert_allclose(new.vel.numpy(), after.vel, atol=2e-3)
    np.testing.assert_allclose(new.traj.numpy(), after.traj, atol=1e-3)
    assert np.abs(new.log_inliers.numpy() - after.log_inliers).max() <= 5
    assert_same(new.kf, after.kf, atol=1e-3)
    assert_same(new.lm, after.lm, atol=1e-3,
                rtol={"pos": 5e-3, "pos_c": 5e-3})


def frames_of(records, kind):
    out = []
    for f, (_, _, _, info) in enumerate(records):
        what = ("keyframe" if info.fire else
                "ba" if info.ba_seq is not None else "tracking")
        if what == kind or (kind == "ba" and info.ba_seq is not None):
            out.append(f)
    return out


@pytest.mark.parametrize("kind", ["tracking", "keyframe", "ba"])
def test_lockstep_step_matches_jax(lockstep, kind):
    """One lockstep step from the JAX state, with the JAX draws: a frame
    that only tracks, one that fires the compact keyframe branch, one that
    runs a window BA (after the bootstrap, so that it has a map)."""
    _, records = lockstep
    frames = [f for f in frames_of(records, kind) if f >= 2 or kind != "ba"]
    assert frames, f"no {kind} frame in the run"
    for f in frames[:2]:
        _, after, new, info = records[f]
        assert_state_matches(new, after)
        if kind == "keyframe":
            assert info.inserted.sum() == 1
            np.testing.assert_array_equal(info.inserted, after.log_kf[:, f])
        if kind == "tracking":
            assert not info.inserted.any() and info.ba_seq is None


def test_lockstep_bootstrap_drains_one_request_per_frame(lockstep):
    """All S sequences ask for a keyframe at frame 0; the compact branch
    serves them one per frame in round-robin order, each followed by its
    window BA, as the JAX step does."""
    _, records = lockstep
    for f in range(S):
        _, after, new, info = records[f]
        assert info.fire and list(np.flatnonzero(info.inserted)) == [f]
        assert info.ba_seq == f
        assert_state_matches(new, after)


SCRIPTS = [
    # take_kf, ba_pending, kf_cursor, ba_cursor
    ([1, 1, 1], [0, 0, 0], 0, 0), ([1, 1, 1], [0, 0, 0], 2, 1),
    ([1, 0, 1], [0, 0, 0], 1, 0), ([1, 1, 0], [1, 0, 0], 0, 2),
    ([0, 0, 0], [1, 0, 1], 0, 1), ([0, 0, 0], [1, 1, 1], 3, 3),
    ([1, 1, 1], [1, 1, 1], 1, 2), ([0, 0, 0], [0, 0, 0], 2, 2),
]


@pytest.mark.parametrize("script", range(len(SCRIPTS)))
def test_round_robin_picks_match_jax(lockstep, worlds, script):
    """Both cursors over scripted request vectors: the sequence that
    inserts, the one whose BA runs, and the vectors and cursors left for
    the next frame equal the JAX step's."""
    jvo, records = lockstep
    take, pend, kc, bc = SCRIPTS[script]
    base = records[-1][1]                     # the state after the run
    before = base._replace(
        take_kf=np.asarray(take, bool), ba_pending=np.asarray(pend, bool),
        kf_cursor=np.int32(kc), ba_cursor=np.int32(bc),
        frame=np.int32(FRAMES - 1))           # replay the last frame
    imgs_l, imgs_r = lockstep_frames(worlds)[-1]
    after = host(jvo._single_step()(
        jax.tree.map(jnp.asarray, before), jnp.asarray(imgs_l),
        jnp.asarray(imgs_r)))
    new, info = port_step(before, imgs_l, imgs_r, worlds[0].calib)
    f = FRAMES - 1
    np.testing.assert_array_equal(info.inserted, after.log_kf[:, f])
    assert (new.kf_cursor, new.ba_cursor) == (int(after.kf_cursor),
                                              int(after.ba_cursor))
    np.testing.assert_array_equal(new.ba_pending.numpy(), after.ba_pending)
    np.testing.assert_array_equal(new.take_kf.numpy(), after.take_kf)
    np.testing.assert_array_equal(new.last_kf_slot.numpy(),
                                  after.last_kf_slot)
    eligible = np.asarray(take, bool) & ~np.asarray(pend, bool)
    assert info.fire == bool(eligible.any())
    pending = np.asarray(pend, bool) | info.inserted
    assert (info.ba_seq is None) == (not pending.any())


def test_round_robin_pick_is_lowest_offset_from_cursor():
    for bits in range(16):
        mask = np.array([(bits >> i) & 1 for i in range(4)], bool)
        for cursor in range(6):
            got = tms.round_robin_pick(mask, cursor)
            if not mask.any():
                assert got is None
                continue
            want = min(np.flatnonzero(mask), key=lambda i: (i - cursor) % 4)
            assert got == want


def batched_inputs(records, worlds, frame):
    before = records[frame][0]
    st = port_state(before)
    img = torch.as_tensor(lockstep_frames(worlds)[frame][0])
    return before, st, img


def test_batched_tracking_equals_single_sequence(lockstep, worlds):
    """Row s of the batched call is ``track_frame`` on sequence s alone,
    given the same draws: equal up to the matches, poses within 1e-4."""
    _, records = lockstep
    cfg = SlamConfig(**CFG)
    kw = step_kwargs(cfg, worlds[0].calib)
    _, st, img = batched_inputs(records, worlds, 5)
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 40, (S, cfg.ransac_hypotheses, 6), generator=g)
    res = ttrack.track_frame(img, st.lm, st.pose, st.last_pose, st.vel,
                             st.intr0, sample_idx=idx, **kw)
    assert res.T_w_c.shape == (S, 7) and res.match_lm.shape == (S, 300)
    for s in range(S):
        one = ttrack.track_frame(
            img[s], tms._at(st.lm, s), st.pose[s], st.last_pose[s], st.vel[s],
            st.intr0, sample_idx=idx[s], **kw)
        for name in ("corners", "angles", "bits", "valid", "octave"):
            assert torch.equal(getattr(res.feats, name)[s],
                               getattr(one.feats, name)), name
        for name in ("match_lm", "had_candidate", "num_matches", "pnp_ok"):
            assert torch.equal(getattr(res, name)[s], getattr(one, name)), \
                name
        assert int(one.num_matches) > 30
        np.testing.assert_allclose(res.T_w_c[s].numpy(), one.T_w_c.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(float(res.motion_err[s]),
                                   float(one.motion_err), atol=1e-3)
        assert abs(int(res.num_inliers[s]) - int(one.num_inliers)) <= 2
        assert int((res.inlier[s] != one.inlier).sum()) <= 2


def test_batched_tracking_draws_come_from_one_generator(lockstep, worlds):
    """Without injected draws the [S, H, 6] indices come from the one
    generator: the same seed repeats the result, sequence by sequence."""
    _, records = lockstep
    kw = step_kwargs(SlamConfig(**CFG), worlds[0].calib)
    _, st, img = batched_inputs(records, worlds, 5)
    outs = [ttrack.track_frame(img, st.lm, st.pose, st.last_pose, st.vel,
                               st.intr0,
                               generator=torch.Generator().manual_seed(9),
                               **kw) for _ in range(2)]
    assert torch.equal(outs[0].T_w_c, outs[1].T_w_c)
    assert bool(outs[0].pnp_ok.all())


def test_batched_tracking_matches_jax_vmap(lockstep, worlds):
    """Against ``jax.vmap(track_frame)`` as the JAX step calls it, with its
    draws: features and matches equal, poses within 1e-4, inlier counts
    within 5."""
    import functools

    _, records = lockstep
    cfg = SlamConfig(**CFG)
    kw = step_kwargs(cfg, worlds[0].calib)
    before, st, img = batched_inputs(records, worlds, 6)
    keys = jax_keys(before)
    res_j = jax.vmap(functools.partial(jtrack.track_frame, **kw),
                     in_axes=(0, 0, 0, 0, 0, 0, None))(
        keys, jnp.asarray(img.numpy()),
        jax.tree.map(jnp.asarray, before.lm), jnp.asarray(before.pose),
        jnp.asarray(before.last_pose), jnp.asarray(before.vel),
        jnp.asarray(before.intr0))
    idx = np.stack([np.asarray(jpnp._sample_minimal(
        keys[s], res_j.match_lm[s] >= 0, cfg.ransac_hypotheses, 6))
        for s in range(S)])
    res = ttrack.track_frame(img, st.lm, st.pose, st.last_pose, st.vel,
                             st.intr0, sample_idx=torch.as_tensor(idx), **kw)
    assert_same(res.feats, res_j.feats)
    np.testing.assert_array_equal(res.match_lm.numpy(),
                                  np.asarray(res_j.match_lm))
    np.testing.assert_array_equal(res.had_candidate.numpy(),
                                  np.asarray(res_j.had_candidate))
    np.testing.assert_array_equal(res.pnp_ok.numpy(),
                                  np.asarray(res_j.pnp_ok))
    np.testing.assert_allclose(res.T_w_c.numpy(), np.asarray(res_j.T_w_c),
                               atol=1e-4)
    assert np.abs(res.num_inliers.numpy()
                  - np.asarray(res_j.num_inliers)).max() <= 5
    assert int(res.num_matches.min()) > 30


def test_batched_track_frame_over_a_mesh(lockstep, worlds):
    """The constructor over a CPU mesh: neighbouring entries of one device
    are one batched call, so the result equals the direct call; a count
    of sequences that does not divide over the mesh raises."""
    _, records = lockstep
    cfg = SlamConfig(**CFG)
    kw = step_kwargs(cfg, worlds[0].calib)
    _, st, img = batched_inputs(records, worlds, 5)
    idx = torch.randint(0, 40, (S, cfg.ransac_hypotheses, 6),
                        generator=torch.Generator().manual_seed(3))
    direct = ttrack.track_frame(img, st.lm, st.pose, st.last_pose, st.vel,
                                st.intr0, sample_idx=idx, **kw)
    fn = multiseq.batched_track_frame(make_mesh(3, devices=["cpu"] * 3),
                                      **kw)
    res = fn(img, st.lm, st.pose, st.last_pose, st.vel, st.intr0,
             sample_idx=idx)
    assert torch.equal(res.T_w_c, direct.T_w_c)
    assert torch.equal(res.match_lm, direct.match_lm)
    assert torch.equal(res.feats.bits, direct.feats.bits)
    with pytest.raises(ValueError, match="do not divide"):
        multiseq.batched_track_frame(make_mesh(2, devices=["cpu"] * 2),
                                     **kw)(img, st.lm, st.pose, st.last_pose,
                                           st.vel, st.intr0, sample_idx=idx)


def test_batched_track_frame_per_sequence_intrinsics_match_jax(lockstep,
                                                               worlds):
    """The constructors of both packages, each over a 3-device mesh, with
    one intrinsics row per sequence ([S, 8], three different cameras) and
    the JAX draws: features and matches equal, poses within 1e-4, inlier
    counts within 5."""
    from vslam_tpu.parallel import multiseq as jmultiseq
    from vslam_tpu.parallel.mesh import make_mesh as jax_make_mesh

    if len(jax.devices()) < S:
        pytest.skip(f"the JAX side needs {S} CPU devices")
    _, records = lockstep
    cfg = SlamConfig(**CFG)
    kw = step_kwargs(cfg, worlds[0].calib)
    before, st, img = batched_inputs(records, worlds, 6)
    # the world's camera, and two whose focal lengths and centres differ
    intr = np.tile(np.asarray(before.intr0, np.float32), (S, 1))
    intr[:, :2] *= np.asarray([0.98, 1.0, 1.02], np.float32)[:, None]
    intr[:, 2] += np.asarray([-2.0, 0.0, 3.0], np.float32)
    keys = jax_keys(before)
    res_j = jmultiseq.batched_track_frame(jax_make_mesh(S), **kw)(
        keys, jnp.asarray(img.numpy()),
        jax.tree.map(jnp.asarray, before.lm), jnp.asarray(before.pose),
        jnp.asarray(before.last_pose), jnp.asarray(before.vel),
        jnp.asarray(intr))
    idx = np.stack([np.asarray(jpnp._sample_minimal(
        keys[s], res_j.match_lm[s] >= 0, cfg.ransac_hypotheses, 6))
        for s in range(S)])
    fn = multiseq.batched_track_frame(make_mesh(S, devices=["cpu"] * S),
                                      **kw)
    res = fn(img, st.lm, st.pose, st.last_pose, st.vel, torch.as_tensor(intr),
             sample_idx=torch.as_tensor(idx))
    assert_same(res.feats, res_j.feats)
    np.testing.assert_array_equal(res.match_lm.numpy(),
                                  np.asarray(res_j.match_lm))
    np.testing.assert_array_equal(res.had_candidate.numpy(),
                                  np.asarray(res_j.had_candidate))
    np.testing.assert_array_equal(res.num_matches.numpy(),
                                  np.asarray(res_j.num_matches))
    np.testing.assert_array_equal(res.pnp_ok.numpy(),
                                  np.asarray(res_j.pnp_ok))
    np.testing.assert_allclose(res.T_w_c.numpy(), np.asarray(res_j.T_w_c),
                               atol=1e-4)
    assert np.abs(res.num_inliers.numpy()
                  - np.asarray(res_j.num_inliers)).max() <= 5
    assert int(res.num_matches.min()) > 30
    # against the shared row: the world's camera gives the same pose, the
    # other two cameras other poses
    shared = fn(img, st.lm, st.pose, st.last_pose, st.vel, st.intr0,
                sample_idx=torch.as_tensor(idx))
    moved = (shared.T_w_c - res.T_w_c).abs().amax(-1)
    assert float(moved[1]) == 0.0 and bool((moved[[0, 2]] > 1e-3).all())


def test_interop_roundtrip_multiseq_state(lockstep):
    """A JAX ``MultiSeqState`` as numpy arrays becomes the port's (``key``
    dropped, cursors and frame as host integers) and comes back equal,
    stacked [S, ...] keyframe and landmark states included."""
    jvo, records = lockstep
    after = records[-1][1]
    st = port_state(after)
    assert not hasattr(st, "key")
    assert (st.frame, st.ba_cursor, st.kf_cursor) == (
        int(after.frame), int(after.ba_cursor), int(after.kf_cursor))
    assert st.kf.pose_l.shape == (S, 16, 7) and st.lm.valid.shape == (S, 2048)
    assert_same(st.kf, after.kf, atol=0)
    assert_same(st.lm, after.lm, atol=0)
    back = interop.to_arrays(st)
    for name in ("pose", "vel", "take_kf", "ba_pending", "traj", "log_kf",
                 "log_inliers", "last_kf_slot", "T_0_1"):
        np.testing.assert_array_equal(back[name], getattr(after, name),
                                      err_msg=name)
    np.testing.assert_array_equal(back["lm"]["bank_bits"],
                                  after.lm.bank_bits)
    again = interop.from_arrays(tms.MultiSeqState, back, "cpu")
    assert torch.equal(again.kf.desc, st.kf.desc) and again.frame == st.frame


def test_period_batched_branch_with_a_cpu_mesh(worlds):
    """A mesh selects the period-batched keyframe branch: every eligible
    sequence inserts on a period boundary and on no other frame, and the
    window BAs drain one per frame."""
    cfg = SlamConfig(**{**CFG, "multiseq_kf_period": 3})
    vo = tms.MultiSeqVO(worlds[0].calib, S, cfg,
                        mesh=make_mesh(2, devices=["cpu", "cpu"]),
                        max_frames=16, device="cpu")
    vo.run(lockstep_frames(worlds))
    log_kf = vo.results()["is_keyframe"]
    assert log_kf[:, 0].all(), "every sequence bootstraps on frame 0"
    assert not log_kf[:, [1, 2, 4, 5, 7, 8]].any()
    assert [i.ba_seq for i in vo.infos[:3]] == [0, 1, 2]
    # a sequence whose BA is still pending on a boundary does not insert
    for f, info in enumerate(vo.infos):
        assert info.fire == bool(info.inserted.any())
        assert not info.fire or f % 3 == 0
    for s, w in enumerate(worlds):
        est = vo.trajectories[s][:, :3]
        assert np.isfinite(est).all()
        assert ate.align_svd(est, w.poses[:FRAMES, :3])[2] < 0.15
        assert int(vo.lm.valid[s].sum()) > 50


def test_period_batched_branch_matches_jax_mesh(worlds):
    """The same run through the JAX driver over a two-device CPU mesh (two
    sequences): the keyframe pattern, the cursors and the request vectors
    agree frame by frame."""
    from vslam_tpu.parallel.mesh import make_mesh as jax_make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("the JAX side needs two CPU devices")
    kw = {**CFG, "multiseq_kf_period": 2}
    jvo = jms.MultiSeqVO(worlds[0].calib, 2, JaxConfig(**kw),
                         mesh=jax_make_mesh(2), max_frames=16)
    vo = tms.MultiSeqVO(worlds[0].calib, 2, SlamConfig(**kw),
                        mesh=make_mesh(2, devices=["cpu", "cpu"]),
                        max_frames=16, device="cpu")
    for imgs_l, imgs_r in lockstep_frames(worlds[:2], 5):
        jvo.process_frames(imgs_l, imgs_r)
        vo.process_frames(imgs_l, imgs_r)
        js = host(jvo.state)
        np.testing.assert_array_equal(vo.state.log_kf.numpy(), js.log_kf)
        np.testing.assert_array_equal(vo.state.ba_pending.numpy(),
                                      js.ba_pending)
        np.testing.assert_array_equal(vo.state.last_kf_slot.numpy(),
                                      js.last_kf_slot)
        assert vo.state.ba_cursor == int(js.ba_cursor)
    assert vo.state.log_kf[:, 0].all()


def test_multiseq_vo_two_sequences():
    """tests/test_multiseq.py's two worlds at its configuration and its
    bars: ATE < 0.15 m per sequence and more than 50 landmarks each."""
    cfg = SlamConfig(
        num_features=400, ransac_hypotheses=128, max_landmarks=8192,
        max_keyframes=64, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=8,
        enable_relocalization=False, enable_loop_closure=False,
        new_kf_min_inliers=60)
    seqs = [synthetic.generate(num_frames=12, num_points=500, seed=seed)
            for seed in (3, 11)]
    ms = tms.MultiSeqVO(seqs[0].calib, num_sequences=2, config=cfg,
                        device="cpu")
    packed = ms.pack_frames(lockstep_frames(seqs, 12))
    assert packed.shape == (12, 2, 2, 240, 320)
    assert ms.run(packed) == 12
    res = ms.results()
    assert res["frames"] == 12 and res["inliers"].shape == (2, 12)
    for s, seq in enumerate(seqs):
        est = ms.trajectories[s][:, :3]
        assert ate.align_svd(est, seq.poses[:, :3])[2] < 0.15
        assert int(ms.lm.valid[s].sum()) > 50
        assert res["is_keyframe"][s].sum() >= 2
    # the kernels' counts stay untouched on the CPU
    from vslam_tpu_torch.ops import cuda_hamming

    assert cuda_hamming.LAUNCHES == {"landmark_top2": 0, "hamming_top2": 0}


def test_max_frames_overflow_drops_writes(worlds):
    vo = tms.MultiSeqVO(worlds[0].calib, S, SlamConfig(**CFG), max_frames=3,
                        device="cpu")
    vo.run(lockstep_frames(worlds, 5))
    res = vo.results()
    assert res["frames"] == 5 and vo.state.frame == 5
    assert res["trajectories"].shape == (S, 3, 7)
    assert len(vo.trajectories[0]) == 3 and len(vo.infos) == 5
    vo.reset()
    assert vo.state.frame == 0 and not vo.state.traj.any()
    assert bool(vo.state.take_kf.all())


def test_multiseq_vo_defaults_to_the_card(worlds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tms.MultiSeqVO(worlds[0].calib, S, SlamConfig(**CFG))


def test_put_skips_views_and_copies_new_tensors():
    """The write-back of a single-sequence result: a field that still is
    the batch's own view is left alone, a new tensor is copied in."""
    @dataclasses.dataclass
    class Two:
        a: torch.Tensor
        b: torch.Tensor

    batch = Two(torch.zeros(3, 4), torch.zeros(3, 2))
    one = tms._at(batch, 1)
    one.a += 1.0                          # in place: lands in the batch
    tms._put(batch, 1, dataclasses.replace(one, b=torch.ones(2)))
    assert batch.a[1].eq(1).all() and batch.b[1].eq(1).all()
    assert not batch.a[0].any() and not batch.b[2].any()
