"""Two branches the multi-sequence path leans on, beside the reference (the
JAX package on the CPU against the port on the CPU, the same numpy / JAX
made inputs through both):

- the window BA's ``obs_per_lm`` subsample (the multi-sequence BA passes
  ``cfg.ba_obs_per_lm``): tests/test_ba_window_subsample.py's two cases;
- the landmark table under pressure (eight tables are culled by the
  lockstep keyframe branch): tests/test_lm_recycling.py's three cases.

Integer and boolean fields must be equal; float fields within 1e-5, new
landmarks' positions within 5e-3 relative plus 1e-3 m (float32 midpoint
triangulation of points 5 m away over a 0.2 m baseline, see
tests/test_torch_streaming.py; the absolute part covers coordinates near
zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_lm_recycling as jrec
from test_ba_window_subsample import _toy_map
from test_torch_streaming import assert_same, tt
from vslam_tpu.geometry import lie as jlie
from vslam_tpu.pipeline import ba_window as jbaw
from vslam_tpu.pipeline import keyframe as jkf
from vslam_tpu_torch import interop
from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
from vslam_tpu_torch.frontend.features import Features
from vslam_tpu_torch.pipeline import ba_window as tbaw
from vslam_tpu_torch.pipeline import keyframe as tkf

POS_RTOL = {"pos": 5e-3, "pos_c": 5e-3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(kf, lm):
    return (interop.from_arrays(KeyframeState, kf._asdict(), "cpu"),
            interop.from_arrays(LandmarkState, lm._asdict(), "cpu"))


@pytest.mark.parametrize("obs_per_lm", [0, 2, 8])
def test_window_subsample_matches_jax(obs_per_lm):
    """k = 2 keeps the two newest in-window observations of each landmark
    (by the observing keyframe's frame id, not its slot); k = 0 and k >= M
    keep them all. The whole problem equals the JAX function's."""
    kf, lm, frame_ids, n_lm = _toy_map()
    intr = np.array([300, 300, 376, 240, 0.5, 0, 0, 0], np.float32)
    kw = dict(W2=4, Lw=8, O=64, obs_per_lm=obs_per_lm)
    wj = jbaw.build_window_problem(kf, lm, jnp.asarray(intr),
                                   jnp.asarray(intr), **kw)
    kt, lt = port(kf, lm)
    wt = tbaw.build_window_problem(kt, lt, tt(intr), tt(intr), **kw)
    assert_same(wt.prob, wj.prob, atol=0)
    for name in ("sel_kf", "sel_kf_valid", "sel_lm", "sel_lm_valid",
                 "obs_dropped"):
        np.testing.assert_array_equal(getattr(wt, name).numpy(),
                                      np.asarray(getattr(wj, name)),
                                      err_msg=name)
    # the pairs (landmark, observing frame) are the newest k per landmark
    valid = wt.prob.obs_valid.numpy()
    pairs = {(int(wt.sel_lm[p]), int(frame_ids[int(wt.sel_kf[w // 2])]))
             for p, w in zip(wt.prob.obs_point.numpy()[valid],
                             wt.prob.obs_cam.numpy()[valid])}
    want = set()
    for i in range(n_lm):
        seen = sorted(frame_ids[:min(4, (i % 4) + 2)])
        for f in (seen[-obs_per_lm:] if 0 < obs_per_lm < 8 else seen):
            want.add((i, int(f)))
    assert pairs == want


def _insert_both(kj, lj, kt, lt, frame, pose, f_l, f_r, match_lm=None,
                 lm_inlier=None):
    """tests/test_lm_recycling.py's ``_insert`` through both packages."""
    out_j = jrec._insert(kj, lj, frame, pose, f_l, f_r, match_lm, lm_inlier)
    n = jrec.N
    ml = (np.full(n, -1, np.int32) if match_lm is None
          else np.asarray(match_lm))
    li = np.zeros(n, bool) if lm_inlier is None else np.asarray(lm_inlier)
    out_t = tkf.insert_keyframe(
        kt, lt, frame, torch.tensor(-1, dtype=torch.int32), tt(pose),
        tt(jrec.T_0_1), interop.from_arrays(Features, f_l, "cpu"),
        interop.from_arrays(Features, f_r, "cpu"),
        torch.arange(n), torch.ones(n, dtype=torch.bool), tt(ml), tt(li),
        tt(jrec.INTR), tt(jrec.INTR), cam_name="pinhole")
    assert int(out_t.num_new) == int(out_j.num_new)
    assert int(out_t.slot) == int(out_j.slot)
    return out_j, out_t


def _same_maps(kt, lt, kj, lj):
    assert_same(kt, kj)
    assert_same(lt, lj, atol=1e-3, rtol=POS_RTOL)


def test_recycling_sustains_3x_capacity_allocations_like_jax():
    from vslam_tpu.core import state as jstate

    kj = jstate.init_keyframes(jrec.K_CAP, jrec.N)
    lj = jstate.init_landmarks(jrec.L_CAP, M=8, M2=8, B=2)
    kt, lt = port(kj, lj)
    key = jax.random.PRNGKey(0)
    window, total = [], 0
    for step in range(16):
        key, k = jax.random.split(key)
        pose = jlie.identity_pose().at[0].set(0.3 * step)
        f_l, f_r = jrec._fake_features(k, pose, jrec.T_0_1)
        out_j, out_t = _insert_both(kj, lj, kt, lt, step, pose, f_l, f_r)
        kj, lj, kt, lt = out_j.kf, out_j.lm, out_t.kf, out_t.lm
        total += int(out_t.num_new)
        window.append(int(out_t.slot))
        if len(window) > 2:
            mask = np.zeros(jrec.K_CAP, bool)
            mask[window.pop(0)] = True
            kj, lj = jkf.deactivate_keyframes(kj, lj, jnp.asarray(mask))
            kt, lt = tkf.deactivate_keyframes(kt, lt, tt(mask))
        # the pressure test, as the drivers make it
        assert int(lt.valid.sum()) == int(jnp.sum(lj.valid))
        if int(lt.valid.sum()) >= 0.7 * jrec.L_CAP:
            kj, lj, nj = jkf.cull_landmarks(kj, lj, min_lifetime_obs=3)
            kt, lt, nt = tkf.cull_landmarks(kt, lt, min_lifetime_obs=3)
            assert int(nt) == int(nj)
        jrec._integrity(*(type("S", (), interop.to_arrays(x))
                          for x in (kt, lt)))
        assert int(out_t.num_new) == jrec.N, step
        _same_maps(kt, lt, kj, lj)
    assert total >= 3 * jrec.L_CAP and int(lt.valid.sum()) <= jrec.L_CAP


def test_strongly_observed_landmarks_survive_cull_like_jax():
    from vslam_tpu.core import state as jstate

    N = jrec.N
    kj = jstate.init_keyframes(jrec.K_CAP, N)
    lj = jstate.init_landmarks(jrec.L_CAP, M=8, M2=8, B=2)
    kt, lt = port(kj, lj)
    key = jax.random.PRNGKey(1)
    pose0 = jlie.identity_pose()
    f_l, f_r = jrec._fake_features(key, pose0, jrec.T_0_1)
    out_j, out_t = _insert_both(kj, lj, kt, lt, 0, pose0, f_l, f_r)
    kj, lj, kt, lt = out_j.kf, out_j.lm, out_t.kf, out_t.lm
    first = out_t.kf.map_points[int(out_t.slot)].numpy()
    assert (first >= 0).all()
    for frame in (1, 2):
        key, k = jax.random.split(key)
        pose = jlie.identity_pose().at[0].set(0.05 * frame)
        fl2, fr2 = jrec._fake_features(k, pose, jrec.T_0_1)
        out_j, out_t = _insert_both(
            kj, lj, kt, lt, frame, pose, fl2, fr2,
            match_lm=jnp.asarray(first, jnp.int32),
            lm_inlier=jnp.ones((N,), bool))
        kj, lj, kt, lt = out_j.kf, out_j.lm, out_t.kf, out_t.lm
    mask = np.ones(jrec.K_CAP, bool)

    def evict_and_cull(kj, lj, kt, lt):
        kj, lj = jkf.deactivate_keyframes(kj, lj, jnp.asarray(mask),
                                          max_evict=jrec.K_CAP)
        kt, lt = tkf.deactivate_keyframes(kt, lt, tt(mask),
                                          max_evict=jrec.K_CAP)
        assert not lt.active.any()
        kj, lj, nj = jkf.cull_landmarks(kj, lj, min_lifetime_obs=3)
        kt, lt, nt = tkf.cull_landmarks(kt, lt, min_lifetime_obs=3)
        assert int(nt) == int(nj)
        _same_maps(kt, lt, kj, lj)
        return kj, lj, kt, lt, int(nt)

    kj, lj, kt, lt, _ = evict_and_cull(kj, lj, kt, lt)
    assert lt.valid.numpy()[first].all(), "strongly observed ones culled"
    # a weak batch, inserted then orphaned, is culled and its slots reused
    key, k = jax.random.split(key)
    pose = jlie.identity_pose().at[0].set(1.0)
    fl3, fr3 = jrec._fake_features(k, pose, jrec.T_0_1)
    out_j, out_t = _insert_both(kj, lj, kt, lt, 3, pose, fl3, fr3)
    weak = out_t.kf.map_points[int(out_t.slot)].numpy()
    weak = weak[weak >= 0]
    kj, lj, kt, lt, n_culled = evict_and_cull(out_j.kf, out_j.lm, out_t.kf,
                                              out_t.lm)
    assert n_culled == len(weak) and not lt.valid.numpy()[weak].any()
    mp = kt.map_points.numpy()
    assert not np.isin(mp[mp >= 0], weak).any()
    key, k = jax.random.split(key)
    fl4, fr4 = jrec._fake_features(k, pose, jrec.T_0_1)
    out_j, out_t = _insert_both(kj, lj, kt, lt, 4, pose, fl4, fr4)
    new_mp = out_t.kf.map_points[int(out_t.slot)].numpy()
    assert np.isin(new_mp[new_mp >= 0], weak).all(), "freed slots not reused"
    _same_maps(out_t.kf, out_t.lm, out_j.kf, out_j.lm)


def test_full_table_observation_drops_not_clobbers_like_jax():
    from vslam_tpu.core import state as jstate

    N = jrec.N
    kj = jstate.init_keyframes(jrec.K_CAP, N)
    lj = jstate.init_landmarks(jrec.L_CAP, M=2, M2=2, B=2)
    kt, lt = port(kj, lj)
    pose = jlie.identity_pose()
    f_l, f_r = jrec._fake_features(jax.random.PRNGKey(2), pose, jrec.T_0_1)
    out_j, out_t = _insert_both(kj, lj, kt, lt, 0, pose, f_l, f_r)
    row0 = int(out_t.kf.map_points[int(out_t.slot)][0])
    before = out_t.lm.obs_kf[row0].clone()
    assert (before >= 0).all()
    out_j2, out_t2 = _insert_both(
        out_j.kf, out_j.lm, out_t.kf, out_t.lm, 1, pose, f_l, f_r,
        match_lm=jnp.full((N,), -1, jnp.int32).at[0].set(row0),
        lm_inlier=jnp.zeros((N,), bool).at[0].set(True))
    assert torch.equal(out_t2.lm.obs_kf[row0], before)
    _same_maps(out_t2.kf, out_t2.lm, out_j2.kf, out_j2.lm)
