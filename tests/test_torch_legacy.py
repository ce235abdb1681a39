"""The legacy SfM surface through the port: feature tracks, the SfM
helpers and the relative-pose RANSAC, on tests/test_sfm_tracks.py's and
tests/test_relative_pose_planar.py's scenes and bars, with the JAX
package's sample indices injected (torch cannot reproduce
``jax.random``), and against the JAX functions' results on those draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_relative_pose_planar import _make_scene, _pose_err
from test_sfm_tracks import make_two_view
from vslam_tpu.geometry import cameras as jcam
from vslam_tpu.geometry import lie as jlie
from vslam_tpu.pipeline import sfm as jsfm
from vslam_tpu.solvers import pnp as jpnp
from vslam_tpu.solvers import relative_pose as jrp
from vslam_tpu_torch.geometry import lie
from vslam_tpu_torch.pipeline import sfm
from vslam_tpu_torch.solvers import relative_pose as rp
from vslam_tpu_torch.utils.tracks import (UnionFind, build_tracks,
                                          tracks_in_images)

INTR = np.array([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def draws(key, valid, size, num_hyp=256):
    return t(jpnp._sample_minimal(key, jnp.asarray(valid), num_hyp, size))


# ---------------------------------------------------------------------------
# tracks (tests/test_sfm_tracks.py)
# ---------------------------------------------------------------------------

def test_union_find():
    uf = UnionFind(6)
    uf.union(0, 1)
    uf.union(1, 2)
    uf.union(4, 5)
    assert uf.find(0) == uf.find(2)
    assert uf.find(3) == 3
    assert uf.find(4) == uf.find(5) != uf.find(0)


def test_build_tracks_and_consistency():
    matches = {(0, 1): [(0, 10), (1, 11)], (1, 2): [(10, 20), (11, 21)],
               (0, 2): [(0, 20)]}
    tracks = build_tracks(matches)
    assert sorted(len(tr) for tr in tracks.values()) == [3, 3]
    assert len(tracks_in_images(tracks, [0, 1, 2])) == 2


def test_build_tracks_drops_inconsistent():
    matches = {(0, 1): [(0, 10)], (0, 2): [(1, 20)], (1, 2): [(10, 20)]}
    assert build_tracks(matches) == {}


# ---------------------------------------------------------------------------
# relative pose (tests/test_sfm_tracks.py, tests/test_relative_pose_planar.py)
# ---------------------------------------------------------------------------

def rot_err(T, T_gt):
    return float(torch.linalg.vector_norm(lie.se3_log(lie.se3_mul(
        lie.se3_inv(T), t(T_gt)))[3:]))


def test_ransac_relative_pose():
    f1, f2, T_gt, n_out = make_two_view(jax.random.PRNGKey(0))
    valid = np.ones(f1.shape[0], bool)
    idx = draws(jax.random.PRNGKey(1), valid, 8)
    T, inl, num, ok = rp.ransac_relative_pose(
        t(f1), t(f2), t(valid), threshold=1e-4, sample_idx=idx)
    assert bool(ok)
    assert rot_err(T, T_gt) < 0.02
    t_gt = np.asarray(T_gt)[:3] / np.linalg.norm(np.asarray(T_gt)[:3])
    assert abs(float(T[:3] @ t(t_gt))) > 0.99
    assert int(inl[:n_out].sum()) <= 2
    Tj, inlj, numj, okj = jrp.ransac_relative_pose(
        jax.random.PRNGKey(1), f1, f2, jnp.asarray(valid), threshold=1e-4)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-3)
    assert abs(int(num) - int(numj)) <= 2


def test_essential_and_epipolar_error_match():
    """The 8-point solve: each finite E fits its own sample as the JAX
    package's does, and the epipolar errors of one E are the same. The Es
    themselves are not compared: A^T A has an exact null vector and, on
    these bearings, a second eigenvalue near 1e-7 of the largest, so the
    shifted Cholesky of the inverse iteration succeeds or fails (NaN,
    scoring no inlier) and its vector moves on float32 rounding, in either
    package."""
    f1, f2, _, _ = make_two_view(jax.random.PRNGKey(5), outliers=0)
    f1, f2 = np.asarray(f1), np.asarray(f2)
    idx = np.asarray(draws(jax.random.PRNGKey(6), np.ones(120, bool), 8, 64))
    Ej = np.asarray(jax.vmap(lambda s: jrp._essential_from_sample(
        jnp.asarray(f1)[s], jnp.asarray(f2)[s]))(jnp.asarray(idx)))
    Et = rp._essential_from_sample(t(f1)[idx], t(f2)[idx]).numpy()
    for E in (Et, Ej):
        ok = np.isfinite(E).all((1, 2))
        assert ok.mean() > 0.25
        np.testing.assert_allclose(np.linalg.norm(E[ok], axis=(1, 2)), 1.0,
                                   atol=1e-5)
        fit = np.abs(np.einsum("hsi,hij,hsj->hs", f1[idx][ok], E[ok],
                               f2[idx][ok]))
        assert fit.max() < 1e-3, fit.max()
    ok = np.isfinite(Ej).all((1, 2))
    errs_j = np.stack([np.asarray(jrp._epipolar_error(
        jnp.asarray(E), jnp.asarray(f1), jnp.asarray(f2))) for E in Ej[ok]])
    np.testing.assert_allclose(
        rp._epipolar_error(t(Ej[ok]), t(f1), t(f2)).numpy(), errs_j,
        atol=1e-6)


def test_homography_recovers_planar_pose():
    f1, f2, T_gt = _make_scene(planar=True, noise=5e-4)
    valid = np.ones(f1.shape[0], bool)
    T, H, inl, num, ok = rp.ransac_homography(
        t(f1), t(f2), t(valid), threshold=3e-3,
        sample_idx=draws(jax.random.PRNGKey(0), valid, 4))
    assert bool(ok) and int(num) > 90
    dir_err, rot_err_ = _pose_err(T.numpy(), T_gt)
    assert rot_err_ < 0.02, f"rotation error {rot_err_:.4f} rad"
    assert dir_err < 0.05, f"translation direction error {dir_err:.4f} rad"
    Tj, Hj, _, numj, _ = jrp.ransac_homography(
        jax.random.PRNGKey(0), f1, f2, jnp.asarray(valid), threshold=3e-3)
    assert int(num) == int(numj)
    # the same pose from another library's singular vectors
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-3)


def hybrid(f1, f2, valid, key):
    k_e, k_h = jax.random.split(key)
    return rp.ransac_relative_pose_hybrid(
        t(f1), t(f2), t(valid), threshold=3e-3,
        sample_idx_e=draws(k_e, valid, 8), sample_idx_h=draws(k_h, valid, 4))


@pytest.mark.parametrize("scene", [1, 2, 4, 5])
def test_hybrid_selects_h_on_plane_and_beats_essential(scene):
    f1, f2, T_gt = _make_scene(planar=True, noise=5e-4, seed=scene)
    T, inl, num, ok, used_h = rp.ransac_relative_pose_hybrid(
        t(f1), t(f2), torch.ones(f1.shape[0], dtype=torch.bool),
        threshold=3e-3, generator=torch.Generator().manual_seed(1))
    assert bool(ok)
    assert bool(used_h), "hybrid should pick the homography on a plane"
    dir_h, rot_h = _pose_err(T.numpy(), T_gt)
    assert rot_h < 0.02 and dir_h < 0.06, (rot_h, dir_h)


def test_hybrid_on_plane_with_the_jax_draws():
    """tests/test_relative_pose_planar.py's plane and draws. Every E of the
    plane-induced family has every point as an inlier, so the essential
    model keeps its first finite hypothesis, and which hypotheses are NaN
    is float32 rounding (see above): here the port's first one decomposes
    into the right pose, whose support ties the homography's, and the tie
    keeps E (``s_h > s_e``) where the JAX package's wrong E loses. Both
    packages end on the true pose, and the homography branch agrees."""
    f1, f2, T_gt = _make_scene(planar=True, noise=5e-4, seed=1)
    valid = np.ones(f1.shape[0], bool)
    T, inl, num, ok, used_h = hybrid(f1, f2, valid, jax.random.PRNGKey(1))
    Tj, _, numj, okj, used_hj = jrp.ransac_relative_pose_hybrid(
        jax.random.PRNGKey(1), f1, f2, jnp.asarray(valid), threshold=3e-3)
    assert bool(ok) and bool(okj) and bool(used_hj)
    assert int(num) >= 110 and int(numj) >= 110
    _, k_h = jax.random.split(jax.random.PRNGKey(1))
    Th = rp.ransac_homography(t(f1), t(f2), t(valid), threshold=3e-3,
                              sample_idx=draws(k_h, valid, 4))[0]
    for pose in (T.numpy(), np.asarray(Tj), Th.numpy()):
        dir_, rot_ = _pose_err(pose, T_gt)
        assert rot_ < 0.02 and dir_ < 0.06, (rot_, dir_)


def test_hybrid_keeps_essential_on_general_scene():
    f1, f2, T_gt = _make_scene(planar=False, noise=5e-4, seed=2)
    valid = np.ones(f1.shape[0], bool)
    T, inl, num, ok, used_h = hybrid(f1, f2, valid, jax.random.PRNGKey(2))
    assert bool(ok)
    assert not bool(used_h), "general scene should keep the essential model"
    dir_e, rot_e = _pose_err(T.numpy(), T_gt)
    assert rot_e < 0.02 and dir_e < 0.06, (rot_e, dir_e)


def test_hybrid_draws_from_a_generator():
    f1, f2, T_gt = _make_scene(planar=True, noise=5e-4, seed=1)
    g = torch.Generator().manual_seed(0)
    T, inl, num, ok, used_h = rp.ransac_relative_pose_hybrid(
        t(f1), t(f2), torch.ones(f1.shape[0], dtype=torch.bool),
        threshold=3e-3, generator=g)
    assert bool(ok) and bool(used_h)
    assert _pose_err(T.numpy(), T_gt)[1] < 0.02


def test_homography_error_metric():
    """Exact H maps f2 to f1 with zero sphere-transfer error."""
    f1, f2, _ = _make_scene(planar=True, seed=3)
    valid = np.ones(f1.shape[0], bool)
    _, H, inl, num, ok = rp.ransac_homography(
        t(f1), t(f2), t(valid), threshold=1e-3,
        sample_idx=draws(jax.random.PRNGKey(3), valid, 4))
    err = rp._homography_error(H, t(f1), t(f2))
    assert float(err.median()) < 1e-3
    np.testing.assert_allclose(
        err.numpy(), np.asarray(jrp._homography_error(
            jnp.asarray(H.numpy()), f1, f2)), atol=1e-6)


# ---------------------------------------------------------------------------
# SfM helpers (tests/test_sfm_tracks.py::test_sfm_init_and_localize)
# ---------------------------------------------------------------------------

def test_sfm_init_and_localize():
    rng = np.random.RandomState(0)
    n = 80
    pts_w = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    T_0_1 = np.asarray(jlie.se3_exp(jnp.asarray([0.3, 0, 0, 0, 0.05, 0])))
    T_w_2 = np.asarray(jlie.se3_exp(jnp.asarray(
        [0.5, 0.1, 0.4, 0.02, 0.08, 0.01])))

    def project_into(T_w_c):
        pc = jlie.se3_apply(jlie.se3_inv(jnp.asarray(T_w_c)),
                            jnp.asarray(pts_w, jnp.float32))
        return np.asarray(jcam.project("pinhole", jnp.asarray(INTR), pc))

    corners = {0: project_into(np.asarray(jlie.identity_pose())),
               1: project_into(T_0_1), 2: project_into(T_w_2)}
    tracks = build_tracks({(0, 1): [(i, i) for i in range(n)],
                           (1, 2): [(i, i) for i in range(n)]})
    assert len(tracks) == n
    intr = t(INTR)

    lms, T_w_0, T_w_1 = sfm.initialize_scene_from_stereo_pair(
        tracks, 0, 1, corners[0], corners[1], T_0_1, intr, "pinhole")
    assert len(lms) > n * 0.9
    errs = [np.linalg.norm(lms[tr] - pts_w[tracks[tr][0]]) for tr in lms]
    assert np.median(errs) < 0.05
    jlms, _, _ = jsfm.initialize_scene_from_stereo_pair(
        tracks, 0, 1, corners[0], corners[1], jnp.asarray(T_0_1),
        jnp.asarray(INTR), "pinhole")
    assert sorted(lms) == sorted(jlms)
    for tr in lms:
        np.testing.assert_allclose(lms[tr], jlms[tr], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(T_w_0.numpy(), [0, 0, 0, 0, 0, 0, 1])

    # the JAX helper's draws: over the shared tracks padded to 128
    valid = np.arange(128) < len([tr for tr in tracks if tr in lms])
    idx = draws(jax.random.PRNGKey(3), valid, 6)
    T_est, inl_tids = sfm.localize_camera_tracks(
        2, tracks, corners[2], lms, intr, "pinhole", threshold=1.8e-5,
        sample_idx=idx)
    assert T_est is not None and len(inl_tids) > n * 0.8
    err = lie.se3_log(lie.se3_mul(lie.se3_inv(t(T_w_2)), T_est))
    assert float(err.abs().max()) < 0.02
    Tj, inl_j = jsfm.localize_camera_tracks(
        jax.random.PRNGKey(3), 2, tracks, corners[2], jlms,
        jnp.asarray(INTR), "pinhole", threshold=1.8e-5)
    np.testing.assert_allclose(T_est.numpy(), np.asarray(Tj), atol=1e-3)
    assert abs(len(inl_tids) - len(inl_j)) <= 2


def test_localize_needs_four_tracks():
    tracks = {0: {0: 0, 1: 0}, 1: {0: 1, 1: 1}}
    assert sfm.localize_camera_tracks(
        1, tracks, np.zeros((2, 2)), {0: np.zeros(3), 1: np.ones(3)},
        t(INTR), "pinhole", threshold=1e-4) == (None, [])
