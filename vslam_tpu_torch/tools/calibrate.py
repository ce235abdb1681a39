"""Offline stereo camera calibration from calibration-grid detections.

Port of ``vslam_tpu/tools/calibrate.py``: the reference's sidecar
calibration tool (src/calibration.cpp: full-batch Ceres over per-frame
poses T_w_i, per-camera extrinsics T_i_c, and 8-parameter intrinsics, with
the ReprojectionCostFunctor residual uv - project((T_w_i * T_i_c)^-1 * X),
reprojection.h:46-79; grid geometry aprilgrid.h:39-72).

The whole problem is one LM solve with ``torch.func.jacfwd`` Jacobians over
a packed parameter vector: the problem is small (a few hundred poses x 6 +
2x6 + 2x8), so dense normal equations are cheapest. Gauge: frame 0's pose
fixed. The reference's ``lax.scan`` over iterations is a loop here whose
damping, cost and accept test stay tensors: no host read per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry import cameras as cam_models
from ..geometry import lie


def aprilgrid_points(rows: int = 6, cols: int = 6, size: float = 0.088,
                     spacing: float = 0.3) -> np.ndarray:
    """3D corner positions of an AprilGrid (tagRows x tagCols, 4 corners
    each), z=0 plane. Mirrors the reference's grid geometry semantics
    (aprilgrid.h:39-72: tag size + spacing fraction)."""
    pts = []
    gap = size * (1 + spacing)
    for r in range(rows):
        for c in range(cols):
            x0, y0 = c * gap, r * gap
            pts += [[x0, y0, 0.0], [x0 + size, y0, 0.0],
                    [x0 + size, y0 + size, 0.0], [x0, y0 + size, 0.0]]
    return np.asarray(pts)


class CalibProblem(NamedTuple):
    grid: torch.Tensor        # [G, 3] grid corner positions (world frame)
    # observations: frame f, camera c sees grid corner g at uv
    obs_frame: torch.Tensor   # [O] int32
    obs_cam: torch.Tensor     # [O] int32 (0/1)
    obs_corner: torch.Tensor  # [O] int32
    obs_uv: torch.Tensor      # [O, 2]
    obs_valid: torch.Tensor   # [O] bool
    T_w_i0: torch.Tensor      # [F, 7] initial per-frame body poses
    T_i_c0: torch.Tensor      # [2, 7] initial extrinsics
    intr0: torch.Tensor       # [2, 8] initial intrinsics


def _problem_fns(prob: CalibProblem, cam_name: str):
    """(unpack, residuals) of the packed parameter vector theta."""
    F = prob.T_w_i0.shape[0]
    n_pose, n_ext = 6 * F, 12
    # parameter preconditioning: intrinsics entries live on wildly different
    # scales (focal ~ hundreds, distortion ~ 0.1); scaling the deltas keeps
    # the identity-damped LM steps balanced in f32
    intr_scale = torch.tensor([100.0, 100, 100, 100, 0.1, 0.1, 0.1, 0.1],
                              dtype=prob.T_w_i0.dtype,
                              device=prob.T_w_i0.device)
    f_idx, c_idx, g_idx = (prob.obs_frame.long(), prob.obs_cam.long(),
                           prob.obs_corner.long())

    def unpack(theta):
        d_pose = theta[:n_pose].reshape(F, 6)
        d_ext = theta[n_pose:n_pose + n_ext].reshape(2, 6)
        d_intr = theta[n_pose + n_ext:].reshape(2, 8) * intr_scale
        T_w_i = lie.se3_retract(prob.T_w_i0, d_pose)
        T_i_c = lie.se3_retract(prob.T_i_c0, d_ext)
        return T_w_i, T_i_c, prob.intr0 + d_intr

    def residuals(theta):
        T_w_i, T_i_c, intr = unpack(theta)
        T_w_c = lie.se3_mul(T_w_i[f_idx], T_i_c[c_idx])
        p_c = lie.se3_apply(lie.se3_inv(T_w_c), prob.grid[g_idx])
        pred = cam_models.project(cam_name, intr[c_idx], p_c)
        r = torch.clamp(prob.obs_uv - pred, -1e5, 1e5)
        return torch.nan_to_num(r, nan=0.0, posinf=0.0, neginf=0.0)

    return unpack, residuals


def calibrate(prob: CalibProblem, cam_name: str = "ds", huber: float = 1.0,
              max_iters: int = 25, optimize_intrinsics: bool = True,
              device="cuda"):
    """Returns (T_w_i [F,7], T_i_c [2,7], intr [2,8], stats) on ``device``
    (the card unless the caller names another; raises if there is none),
    where the problem is moved first. ``stats``: initial and final cost and
    the cost tried at each iteration (``history``)."""
    dev = resolve_device(device)
    prob = CalibProblem(*(t.to(dev) for t in prob))
    F = prob.T_w_i0.shape[0]
    dtype = prob.T_w_i0.dtype
    n_pose, n_ext, n_intr = 6 * F, 12, 16
    P = n_pose + n_ext + n_intr
    unpack, residuals = _problem_fns(prob, cam_name)
    jac = torch.func.jacfwd(residuals)

    # gauge + optional intrinsics freeze
    free = torch.ones(P, dtype=dtype, device=dev)
    free[:6] = 0.0  # frame 0 fixed
    if not optimize_intrinsics:
        free[n_pose + n_ext:] = 0.0
    valid = prob.obs_valid.to(dtype)

    def build(theta):
        J = jac(theta)                                      # [O, 2, P]
        r = residuals(theta)
        nrm = torch.linalg.vector_norm(r, dim=-1)
        w = torch.clamp(huber / torch.clamp(nrm, min=1e-12), max=1.0)
        sw = (torch.sqrt(w) * valid)[:, None]
        r = (r * sw).reshape(-1)
        J = (J * sw[..., None]).reshape(r.shape[0], -1) * free[None, :]
        return J.T @ J, J.T @ r

    def cost_of(theta):
        r = residuals(theta)
        s = torch.sum(r * r, dim=-1)
        nrm = torch.sqrt(torch.clamp(s, min=0.0))
        rho = torch.where(nrm <= huber, s, 2 * huber * nrm - huber * huber)
        return torch.sum(torch.where(prob.obs_valid, rho,
                                     torch.zeros_like(rho)))

    eye = torch.eye(P, dtype=dtype, device=dev)
    fixed = torch.diag(torch.where(free > 0, 0.0, 1.0).to(dtype))
    theta = torch.zeros(P, dtype=dtype, device=dev)
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    cost = init_cost = cost_of(theta)
    hist = []
    for _ in range(max_iters):
        H, g = build(theta)
        delta = torch.nan_to_num(
            torch.linalg.solve_ex(H + lam * eye + fixed, -g)[0]) * free
        new_theta = theta + delta
        new_cost = cost_of(new_theta)
        accept = new_cost < cost
        theta = torch.where(accept, new_theta, theta)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-10, 1e8)
        hist.append(new_cost)
    T_w_i, T_i_c, intr = unpack(theta)
    history = torch.stack(hist) if hist else torch.zeros(0, dtype=dtype,
                                                         device=dev)
    return T_w_i, T_i_c, intr, {"initial_cost": init_cost,
                                "final_cost": cost, "history": history}
