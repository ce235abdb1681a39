"""Parity of the port's batched RANSAC PnP with the JAX package.

torch cannot reproduce jax.random's Gumbel draws, so both sides get the
same minimal-sample indices: the JAX package's own draw, handed to the
port through ``ransac_pnp(sample_idx=...)``. Poses agree within 1e-4 (two
Gauss-Newton rounds of float32 normal equations, summed in different
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.geometry import lie as jlie
from vslam_tpu.solvers import pnp as jpnp
from vslam_tpu_torch.solvers import pnp as tpnp

TOL = 1e-4


def make_problem(seed, n=300, outliers=0.3, noise_px=0.5, invalid=0.1):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=4) * [0.1, 0.1, 0.1, 1.0]
    q /= np.linalg.norm(q)
    T_wc = np.concatenate([rng.normal(scale=0.5, size=3), q]).astype(
        np.float32)
    pc = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                         rng.uniform(2, 10, (n, 1))], 1)
    pw = np.asarray(jlie.se3_apply(jnp.asarray(T_wc),
                                   jnp.asarray(pc, jnp.float32)))
    f = pc + rng.normal(scale=noise_px / 500.0, size=pc.shape) * pc[:, 2:]
    bad = rng.rand(n) < outliers
    f[bad] = rng.normal(size=(bad.sum(), 3))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    valid = rng.rand(n) > invalid
    return T_wc, pw.astype(np.float32), f.astype(np.float32), valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_pnp_matches_jax(seed):
    T_gt, pw, f, valid = make_problem(seed)
    thr = jpnp.ransac_threshold(3.0)
    key = jax.random.PRNGKey(seed)
    idx = np.asarray(jpnp._sample_minimal(key, jnp.asarray(valid), 64, 6))
    Tj, inl_j, num_j, ok_j = jpnp.ransac_pnp(
        key, jnp.asarray(pw), jnp.asarray(f), jnp.asarray(valid), thr,
        num_hypotheses=64)
    Tt, inl_t, num_t, ok_t = tpnp.ransac_pnp(
        torch.as_tensor(pw), torch.as_tensor(f), torch.as_tensor(valid), thr,
        num_hypotheses=64, sample_idx=torch.as_tensor(idx))
    assert bool(ok_t) == bool(ok_j)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=TOL, rtol=0)
    # the inlier set can differ only on correspondences at the gate
    assert abs(int(num_t) - int(num_j)) <= 2
    assert (inl_t.numpy() != np.asarray(inl_j)).sum() <= 2
    # and the pose is the true one
    np.testing.assert_allclose(Tt.numpy()[:3], T_gt[:3], atol=0.05)


def test_dlt_pose_matches_jax():
    _, pw, f, valid = make_problem(5, outliers=0.0, noise_px=1.0)
    rng = np.random.RandomState(5)
    idx = np.stack([rng.permutation(len(pw))[:6] for _ in range(32)])
    Rj, tj = jax.vmap(jpnp._dlt_pose)(jnp.asarray(pw[idx]),
                                      jnp.asarray(f[idx]))
    Rt, tt = tpnp._dlt_pose(torch.as_tensor(pw[idx]), torch.as_tensor(f[idx]))
    Rj, tj, Rt, tt = (np.asarray(Rj), np.asarray(tj), Rt.numpy(),
                      tt.numpy())
    # a near-exact sample makes the shifted normal matrix borderline
    # positive definite in float32, and its Cholesky may fail (NaN) on one
    # side only; ransac_pnp zeroes such hypotheses. Compare the rest.
    both = (np.isfinite(Rj).all((1, 2, 3)) & np.isfinite(Rt).all((1, 2, 3))
            & np.isfinite(tj).all((1, 2)) & np.isfinite(tt).all((1, 2)))
    assert both.sum() >= 24
    # the null vector's sign is arbitrary, so the two sign branches may
    # come in either order. Tolerance: the null vector of a 12x12 f32
    # normal matrix from a noisy minimal sample after 12 inverse
    # iterations; the rotation agrees to 1e-3, the translation, which
    # divides by the recovered scale, to 5e-3 m (RANSAC only scores these
    # hypotheses; the Gauss-Newton rounds refine the winner)
    swap = np.abs(Rt[:, 0] - Rj[:, 1]).max((1, 2)) < np.abs(
        Rt[:, 0] - Rj[:, 0]).max((1, 2))
    Rj = np.where(swap[:, None, None, None], Rj[:, ::-1], Rj)
    tj = np.where(swap[:, None, None], tj[:, ::-1], tj)
    np.testing.assert_allclose(Rt[both], Rj[both], atol=1e-3)
    np.testing.assert_allclose(tt[both], tj[both], atol=5e-3)


def test_gn_refine_matches_jax():
    """The port's analytic Jacobian against the reference's jacfwd."""
    T_gt, pw, f, valid = make_problem(7, outliers=0.0)
    T_cw = jlie.se3_inv(jnp.asarray(T_gt))
    # start 2 cm / ~1 degree away
    T0 = jlie.se3_retract(T_cw, jnp.asarray([0.02, -0.01, 0.01, 0.01, 0.02,
                                             -0.01], jnp.float32))
    R0 = jlie.quat_to_matrix(T0[3:])
    w = valid.astype(np.float32)
    Tj = jpnp._gn_refine(R0, T0[:3], jnp.asarray(pw), jnp.asarray(f),
                         jnp.asarray(w))
    Tt = tpnp._gn_refine(torch.as_tensor(np.asarray(R0)),
                         torch.as_tensor(np.asarray(T0[:3])),
                         torch.as_tensor(pw), torch.as_tensor(f),
                         torch.as_tensor(w))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=TOL, rtol=0)


def test_sample_minimal_distinct_valid():
    valid = torch.as_tensor(np.random.RandomState(3).rand(200) > 0.5)
    g = torch.Generator().manual_seed(0)
    idx = tpnp.sample_minimal(valid, 128, 6, generator=g)
    assert idx.shape == (128, 6)
    assert bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 6 for row in idx)
    again = tpnp.sample_minimal(valid, 128, 6,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)
