"""Parity of the port's Schur LM bundle adjustment with the JAX package on
the problems of tests/test_ba_golden.py (and a double-sphere variant with
padding). Poses agree within 1e-4, points within 1e-4 relative, the final
cost within rtol 1e-4: the same LM control law in float32, with sums over
observations taken in another order. Points are compared relatively
because the cost is flat along a far point's viewing ray to about the
solver's function tolerance (1e-6): the two solvers stop at places along
it that differ by up to ~3e-4 m at 7.5 m depth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba_golden import PINHOLE, build_problem
from vslam_tpu.geometry import cameras as jcam
from vslam_tpu.geometry import lie as jlie
from vslam_tpu.solvers import ba as jba
from vslam_tpu_torch import interop
from vslam_tpu_torch.solvers import ba as tba

TOL = 1e-4
DS = np.array([349.0, 348.0, 320.0, 240.0, -0.2, 0.56, 0, 0])


def golden_problem(seed, cam="pinhole", n_cams=5, n_pts=60, pad=0):
    (_, _, poses0, pts0, obs_cam, obs_pt, obs_uv) = build_problem(
        seed=seed, n_cams=n_cams, n_pts=n_pts)
    intr = PINHOLE if cam == "pinhole" else DS
    if cam != "pinhole":
        # re-observe through the double-sphere model (same noise level)
        rng = np.random.RandomState(seed)
        pc = np.asarray(jlie.se3_apply(
            jlie.se3_inv(jnp.asarray(poses0[obs_cam], jnp.float32)),
            jnp.asarray(pts0[obs_pt], jnp.float32)))
        obs_uv = np.asarray(jcam.project(cam, jnp.asarray(intr, jnp.float32),
                                         jnp.asarray(pc)))
        obs_uv = obs_uv + rng.normal(0, 0.4, obs_uv.shape)
    n_obs = len(obs_cam)
    point_valid = np.ones(n_pts + pad, bool)
    point_valid[n_pts:] = False
    pts = np.concatenate([pts0, np.zeros((pad, 3))])
    obs_valid = np.ones(n_obs + pad, bool)
    obs_valid[n_obs:] = False
    return dict(
        poses=np.asarray(poses0, np.float32),
        pose_fixed=np.arange(n_cams) < 2,
        intr=np.tile(np.asarray(intr, np.float32), (n_cams, 1)),
        points=pts.astype(np.float32),
        point_valid=point_valid,
        obs_cam=np.concatenate([obs_cam, np.zeros(pad)]).astype(np.int32),
        obs_point=np.concatenate([obs_pt, np.zeros(pad)]).astype(np.int32),
        obs_uv=np.concatenate([obs_uv, np.zeros((pad, 2))]).astype(
            np.float32),
        obs_valid=obs_valid,
    )


CASES = [(0, "pinhole", 0), (1, "pinhole", 0), (2, "pinhole", 7),
         (3, "ds", 5)]


@pytest.mark.parametrize("seed,cam,pad", CASES)
def test_solve_ba_schur_matches_jax(seed, cam, pad):
    arrays = golden_problem(seed, cam, pad=pad)
    pj, xj, sj = jba.solve_ba_schur(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        cam_name=cam, huber=1.0, max_iters=30)
    prob = interop.from_arrays(tba.BAProblem, arrays)
    pt, xt, st = tba.solve_ba_schur(prob, cam_name=cam, huber=1.0,
                                    max_iters=30)
    np.testing.assert_allclose(float(st["initial_cost"]),
                               float(sj["initial_cost"]), rtol=TOL)
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL, rtol=0)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=TOL, atol=0)
    assert float(st["final_cost"]) < float(st["initial_cost"])


@pytest.mark.parametrize("cam", ["pinhole", "ds"])
def test_normal_equations_match_jax(cam):
    arrays = golden_problem(4, cam, pad=3)
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    out_j = jba._normal_equations(cam, jp, jp.poses, jp.points, 1.0)
    tp = interop.from_arrays(tba.BAProblem, arrays)
    out_t = tba._normal_equations(cam, tp, tp.poses, tp.points, 1.0)
    for name, a, b in zip(["Hcc", "Hpp", "U", "bc", "bp", "r"], out_t,
                          out_j):
        b = np.asarray(b)
        # float32 sums of products of ~1e3-px/m Jacobian entries
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_schur_solve_matches_dense_solve():
    """The Schur-eliminated step equals the full damped normal-equation
    solve (float64 reference on the same blocks)."""
    arrays = golden_problem(5, "pinhole")
    tp = interop.from_arrays(tba.BAProblem, arrays)
    Hcc, Hpp, U, bc, bp, _ = tba._normal_equations("pinhole", tp, tp.poses,
                                                   tp.points, 1.0)
    lam = torch.tensor(1e-3)
    dc, dp = tba._schur_solve(Hcc, Hpp, U, bc, bp, tp.pose_fixed,
                              tp.point_valid, lam)
    K, L = Hcc.shape[0], Hpp.shape[0]
    Hcc, Hpp = Hcc.double().numpy(), Hpp.double().numpy()
    H = np.zeros((6 * K + 3 * L,) * 2)
    for k in range(K):
        H[6 * k:6 * k + 6, 6 * k:6 * k + 6] = Hcc[k] + 1e-3 * np.eye(6)
    for p in range(L):
        s = 6 * K + 3 * p
        H[s:s + 3, s:s + 3] = Hpp[p] + (1e-3 + 1e-8) * np.eye(3)
    Ud = U.double().numpy().reshape(6 * K, 3 * L)
    H[:6 * K, 6 * K:] = Ud
    H[6 * K:, :6 * K] = Ud.T
    g = np.concatenate([bc.double().numpy().ravel(),
                        bp.double().numpy().ravel()])
    free = np.concatenate([np.repeat(~arrays["pose_fixed"], 6),
                           np.ones(3 * L, bool)])
    sol = np.zeros_like(g)
    sol[free] = np.linalg.solve(H[np.ix_(free, free)], -g[free])
    np.testing.assert_allclose(dc.numpy().ravel(), sol[:6 * K], atol=1e-4)
    np.testing.assert_allclose(dp.numpy().ravel(), sol[6 * K:], atol=1e-4)
