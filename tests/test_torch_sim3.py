"""The port's Sim(3) alignment against the JAX package's, on the same
numpy-seeded inputs on the CPU.

- ``horn_align`` (with scale, SE3 mode, weighted, a reflection, a batch of
  triples), ``sim3_apply`` and ``sim3_inv``: R, s and t within 1e-4 (the
  SVD factors differ by signs and are never compared);
- ``ransac_sim3`` with the JAX package's own draws injected (Gumbel top-3
  per split key, recomputed here as ``vslam_tpu/geometry/sim3.py`` draws
  them): R, s, t within 1e-4, inlier masks equal; a degenerate triple
  scores -1 on both sides;
- ``compute_sim3_horn`` on tests/test_sim3.py's drifted-map scenario: the
  same decision, scale and correction (1e-4), and the stereo scale gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core import state as jstate
from vslam_tpu.geometry import sim3 as jsim3
from vslam_tpu.loop import closure as jclosure
from vslam_tpu.ops import describe as jdescribe
from vslam_tpu_torch import interop
from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
from vslam_tpu_torch.geometry import sim3 as tsim3
from vslam_tpu_torch.loop import closure as tclosure

ATOL = 1e-4


def tt(x):
    return torch.as_tensor(np.array(x))


def random_sim3(rng, scale=None):
    """A rotation of 0.2-2.5 rad about a random axis, a scale and a shift."""
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0.2, 2.5)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * Kx @ Kx
    s = scale if scale is not None else rng.uniform(0.3, 3.0)
    return (np.float32(s), R.astype(np.float32),
            (rng.randn(3) * 2.0).astype(np.float32))


def apply(T, p):
    s, R, t = T
    return (s * p @ R.T + t).astype(np.float32)


def jax_draws(key, valid, num_hypotheses):
    """The reference's hypothesis draws (sim3.py:95-104)."""
    n = valid.shape[0]
    validf = jnp.asarray(valid).astype(jnp.float32)

    def sample(k):
        g = jax.random.gumbel(k, (n,)) + jnp.log(validf + 1e-30)
        return jax.lax.top_k(g, 3)[1]

    return np.asarray(jax.vmap(sample)(jax.random.split(key,
                                                        num_hypotheses)))


def assert_sim3_close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), atol=atol,
                               rtol=atol)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=atol)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("case", ["scale", "se3", "weights", "reflection"])
def test_horn_align_matches_jax(case):
    rng = np.random.RandomState(0)
    src = rng.randn(40, 3).astype(np.float32)
    T = random_sim3(rng, scale=1.0 if case == "se3" else None)
    dst = apply(T, src)
    kw = {}
    if case == "se3":
        kw["with_scale"] = False
    if case == "weights":
        dst[30:] += 50.0
        kw["weights"] = (np.arange(40) < 30).astype(np.float32)
    if case == "reflection":
        dst = src.copy()
        dst[:, 0] *= -1.0
    want = jsim3.horn_align(jnp.asarray(src), jnp.asarray(dst), **{
        k: jnp.asarray(v) if k == "weights" else v for k, v in kw.items()})
    got = tsim3.horn_align(tt(src), tt(dst), **{
        k: tt(v) if k == "weights" else v for k, v in kw.items()})
    assert_sim3_close(got, want)
    assert float(torch.linalg.det(got.R)) > 0.99
    if case in ("scale", "weights"):
        np.testing.assert_allclose(got.R.numpy(), T[1], atol=1e-3)
        assert abs(float(got.s) - T[0]) < 1e-3 * T[0]


def test_horn_align_batched_and_apply_inv_match_jax():
    """A batch of minimal triples, as the RANSAC forms it, against the
    reference's vmap; apply and inverse on the batch."""
    rng = np.random.RandomState(1)
    src = (rng.randn(50, 3) * 3).astype(np.float32)
    dst = apply(random_sim3(rng, scale=1.4), src)
    idx = np.stack([rng.choice(50, 3, replace=False) for _ in range(16)])
    want = jax.vmap(lambda ix: jsim3.horn_align(
        jnp.asarray(src)[ix], jnp.asarray(dst)[ix]))(jnp.asarray(idx))
    got = tsim3.horn_align(tt(src)[tt(idx)], tt(dst)[tt(idx)])
    assert got.R.shape == (16, 3, 3)
    assert_sim3_close(got, want, atol=2e-4)

    one = tsim3.Sim3(s=got.s[3], R=got.R[3], t=got.t[3])
    jone = jsim3.Sim3(s=want.s[3], R=want.R[3], t=want.t[3])
    np.testing.assert_allclose(tsim3.sim3_apply(one, tt(src)).numpy(),
                               np.asarray(jsim3.sim3_apply(
                                   jone, jnp.asarray(src))), atol=1e-3)
    assert tsim3.sim3_apply(got, tt(src)).shape == (16, 50, 3)
    assert_sim3_close(tsim3.sim3_inv(one), jsim3.sim3_inv(jone), atol=2e-4)
    back = tsim3.sim3_apply(tsim3.sim3_inv(one),
                            tsim3.sim3_apply(one, tt(src)))
    np.testing.assert_allclose(back.numpy(), src, atol=1e-3)
    inv_b = tsim3.sim3_inv(got)
    assert_sim3_close(tsim3.Sim3(s=inv_b.s[3], R=inv_b.R[3], t=inv_b.t[3]),
                      jsim3.sim3_inv(jone), atol=2e-4)


@pytest.mark.parametrize("seed,n_valid", [(0, 96), (3, 70)])
def test_ransac_sim3_matches_jax_with_injected_draws(seed, n_valid):
    rng = np.random.RandomState(4 + seed)
    n = 96
    src = (rng.randn(n, 3) * 3.0).astype(np.float32)
    T = random_sim3(rng, scale=1.7)
    dst = apply(T, src)
    n_out = 28
    dst[:n_out] = rng.randn(n_out, 3) * 8.0
    valid = np.arange(n) < n_valid
    key = jax.random.PRNGKey(seed)
    Tj, inl_j, n_j, ok_j = jsim3.ransac_sim3(
        key, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
        threshold=0.15, num_hypotheses=128)
    idx = jax_draws(key, valid, 128)
    assert valid[idx].all()
    Tt, inl_t, n_t, ok_t = tsim3.ransac_sim3(
        tt(src), tt(dst), tt(valid), threshold=0.15, num_hypotheses=128,
        sample_idx=tt(idx))
    assert bool(ok_t) and bool(ok_j)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= n_valid - n_out - 3
    assert not inl_t[:n_out].any() and not inl_t[n_valid:].any()
    assert_sim3_close(Tt, Tj)
    assert abs(float(Tt.s) - 1.7) < 0.02


def test_ransac_sim3_own_draws_and_garbage():
    """The port's own generator draws: the outlier-contaminated set is
    recovered; unrelated clouds are refused."""
    rng = np.random.RandomState(5)
    n = 64
    src = (rng.randn(n, 3) * 3.0).astype(np.float32)
    dst = apply(random_sim3(rng, scale=1.0), src)
    dst[:16] = rng.randn(16, 3) * 8.0
    gen = torch.Generator().manual_seed(0)
    T, inl, n_inl, ok = tsim3.ransac_sim3(
        tt(src), tt(dst), torch.ones(n, dtype=torch.bool), threshold=0.15,
        num_hypotheses=128, generator=gen)
    assert bool(ok) and int(n_inl) >= 45 and not inl[:16].any()
    assert abs(float(T.s) - 1.0) < 0.02
    junk = (rng.randn(n, 3) * 5.0).astype(np.float32)
    _, _, n_bad, ok_bad = tsim3.ransac_sim3(
        tt(src), tt(junk), torch.ones(n, dtype=torch.bool), threshold=0.05,
        num_hypotheses=64, min_inliers=8, generator=gen)
    assert not bool(ok_bad) or int(n_bad) < 8


def test_ransac_sim3_degenerate_triples_score_minus_one():
    """Collinear and repeated triples (zero covariance: a determinant sign
    of 0, a scale of 0 or NaN) never win: injected alone with one good
    triple, the good one is chosen on both sides."""
    rng = np.random.RandomState(6)
    n = 32
    src = (rng.randn(n, 3) * 2.0).astype(np.float32)
    src[:3] = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    T = random_sim3(rng, scale=1.2)
    dst = apply(T, src)
    dst[:3] = 0.0       # the collinear triple maps to one point: s = 0
    valid = np.ones(n, bool)
    idx = np.array([[0, 1, 2], [0, 1, 2], [5, 9, 17], [0, 1, 2]])
    Tt, inl_t, n_t, ok_t = tsim3.ransac_sim3(
        tt(src), tt(dst), tt(valid), threshold=0.1, sample_idx=tt(idx))
    assert bool(ok_t) and int(n_t) == n - 3
    assert abs(float(Tt.s) - 1.2) < 1e-2
    np.testing.assert_allclose(Tt.R.numpy(), T[1], atol=1e-3)


def horn_scenario(shrink=None):
    """tests/test_sim3.py::test_horn_loop_correction_end_to_end's map: the
    candidate keyframe (slot 0) sees the old copies of 64 points, the
    current keyframe (slot 1) their drifted copies, same descriptors."""
    rng = np.random.RandomState(7)
    n_pts, N = 64, 128
    pts_old = (rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
               + np.array([0, 0, 6], np.float32))
    drift = np.array([0.8, -0.3, 0.4], np.float32)
    kf = jstate.init_keyframes(4, N)
    lm = jstate.init_landmarks(256, M=8, M2=8, B=2)
    bits = rng.randint(0, 2, (n_pts, 256)).astype(np.uint8)
    desc = np.zeros((2, N, 32), np.uint8)
    desc[0, :n_pts] = np.asarray(jdescribe.pack_bits(jnp.asarray(bits)))
    desc[1] = desc[0]
    kpv = np.zeros((2, N), bool)
    kpv[:, :n_pts] = True
    mp0 = np.full(N, -1, np.int32)
    mp0[:n_pts] = np.arange(n_pts)
    mp1 = np.full(N, -1, np.int32)
    mp1[:n_pts] = np.arange(n_pts) + n_pts
    kf = kf._replace(
        valid=kf.valid.at[0].set(True).at[1].set(True),
        frame_id=kf.frame_id.at[0].set(0).at[1].set(600),
        desc=kf.desc.at[0].set(jnp.asarray(desc)).at[1].set(
            jnp.asarray(desc)),
        kp_valid=kf.kp_valid.at[0].set(jnp.asarray(kpv)).at[1].set(
            jnp.asarray(kpv)),
        map_points=kf.map_points.at[0].set(jnp.asarray(mp0)).at[1].set(
            jnp.asarray(mp1)),
        next_slot=jnp.asarray(2, jnp.int32))
    pos = np.zeros((256, 3), np.float32)
    pos[:n_pts] = pts_old
    pos[n_pts:2 * n_pts] = (pts_old + drift if shrink is None
                            else pts_old * shrink)
    lm = lm._replace(pos=jnp.asarray(pos),
                     valid=jnp.asarray(np.arange(256) < 2 * n_pts))
    return kf, lm, drift


@pytest.mark.parametrize("shrink", [None, 0.75])
def test_compute_sim3_horn_matches_jax(shrink):
    kf, lm, drift = horn_scenario(shrink)
    kt = interop.from_arrays(KeyframeState, kf._asdict(), "cpu")
    lt = interop.from_arrays(LandmarkState, lm._asdict(), "cpu")
    key = jax.random.PRNGKey(2)
    ok_j, sim3_j, scale_j = jclosure.compute_sim3_horn(
        kf, lm, cur_slot=1, cand_slot=0, cand_neighbors=[], key=key)
    idx = jax_draws(key, np.ones(64, bool), 128)
    ok_t, sim3_t, scale_t = tclosure.compute_sim3_horn(
        kt, lt, cur_slot=1, cand_slot=0, cand_neighbors=[],
        sample_idx=tt(idx))
    assert ok_t == ok_j == (shrink is None)
    assert abs(scale_t - scale_j) < ATOL
    if shrink is None:
        np.testing.assert_allclose(sim3_t.numpy(), np.asarray(sim3_j),
                                   atol=ATOL)
        np.testing.assert_allclose(sim3_t.numpy()[:3], -drift, atol=0.05)
        # and from the port's own generator
        ok_g, sim3_g, scale_g = tclosure.compute_sim3_horn(
            kt, lt, 1, 0, [], torch.Generator().manual_seed(1))
        assert ok_g and abs(scale_g - 1.0) < 0.01
        np.testing.assert_allclose(sim3_g.numpy()[:3], -drift, atol=0.05)
    else:
        assert sim3_t is None and abs(scale_t - 1.0 / 0.75) < 0.1


def test_compute_sim3_horn_refuses_thin_harvest():
    kf, lm, _ = horn_scenario()
    kf = kf._replace(kp_valid=kf.kp_valid.at[1, 0, 3:].set(False))
    kt = interop.from_arrays(KeyframeState, kf._asdict(), "cpu")
    lt = interop.from_arrays(LandmarkState, lm._asdict(), "cpu")
    assert tclosure.compute_sim3_horn(
        kt, lt, 1, 0, [], torch.Generator()) == (False, None, 0.0)
    assert jclosure.compute_sim3_horn(
        kf, lm, 1, 0, [], jax.random.PRNGKey(0)) == (False, None, 0.0)
