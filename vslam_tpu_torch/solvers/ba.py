"""Bundle adjustment: Levenberg-Marquardt with an explicit Schur complement.

Port of ``vslam_tpu/solvers/ba.py``, ``solve_ba_schur`` with its dense
branch (``_normal_equations`` + ``_schur_solve``): residual
``r = uv - project(T_w_c^-1 X)`` per observation, blockwise Huber IRLS
weights, SE3 right-multiplicative updates, gauge fixed by frozen cameras,
and the landmark block eliminated explicitly (batched 3x3 inverses, the
coupling densified to U [K, 6, L, 3], a dense (6K, 6K) reduced camera
system).

Pose and point Jacobians are analytic through the SE3 chain; only the
camera projection's Jacobian dproj/dp_c is forward-mode autodiff, taken as
three ``torch.func.jvp`` calls over the whole observation batch (one per
input axis; each output row depends on its own input row only).
``jax.ops.segment_sum`` becomes ``index_add_`` (on the card an atomic sum,
so the summation order, and the last bits, vary from run to run).

The reference's ``lax.while_loop`` is a host loop with the same function
tolerance, gradient tolerance and stuck exit: one host read of the exit
flag per LM iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import TensorState
from ..geometry import cameras as cam_models
from ..geometry import lie


@dataclasses.dataclass
class BAProblem(TensorState):
    """Padded dense BA problem. K cameras, L points, O observations."""

    poses: torch.Tensor        # [K, 7] T_w_c
    pose_fixed: torch.Tensor   # [K] bool (gauge / inactive)
    intr: torch.Tensor         # [K, 8] per-camera intrinsics
    points: torch.Tensor       # [L, 3]
    point_valid: torch.Tensor  # [L] bool
    obs_cam: torch.Tensor      # [O] int32 -> K axis
    obs_point: torch.Tensor    # [O] int32 -> L axis
    obs_uv: torch.Tensor       # [O, 2]
    obs_valid: torch.Tensor    # [O] bool


RESIDUAL_CLIP = 1e5  # px; observations behind a camera can otherwise
# produce ~1/z^2 residuals whose f32 square overflows to inf, and
# inf * 0-weight = NaN poisons the normal equations.


def _sanitize(x):
    """Zero out NaN/inf entries (degenerate Jacobians of outliers)."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _segment_sum(data, ids, num_segments: int):
    """sum of data rows per segment id (ids must lie in [0, num_segments))."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids, data)


def _cam_inverse(poses):
    """Per-camera world->cam transform: R_cw [K,3,3], t_cw [K,3]."""
    R_cw = lie.quat_to_matrix(poses[..., 3:7]).transpose(-1, -2)
    t_cw = -torch.einsum("...ij,...j->...i", R_cw, poses[..., :3])
    return R_cw, t_cw


def _obs_p_c(prob: BAProblem, poses, points):
    """Camera-frame points p_c [O,3] + gathered R_cw [O,3,3], intr [O,8]."""
    cam = prob.obs_cam.long()
    R_cw, t_cw = _cam_inverse(poses)
    Rg = R_cw[cam]
    p_c = (torch.einsum("oij,oj->oi", Rg, points[prob.obs_point.long()])
           + t_cw[cam])
    return p_c, Rg, prob.intr[cam]


def _residuals(cam_name, prob: BAProblem, poses, points):
    """r = uv - project(p_c) [O,2]."""
    p_c, _, intr = _obs_p_c(prob, poses, points)
    pred = cam_models.project(cam_name, intr, p_c)
    return torch.clamp(prob.obs_uv - pred, -RESIDUAL_CLIP, RESIDUAL_CLIP)


def project_jacobian(cam_name, intr, p_c):
    """(project(intr, p_c) [O,2], dproj/dp_c [O,2,3]) by forward mode."""
    def proj(p):
        return cam_models.project(cam_name, intr, p)

    pred, cols = None, []
    for k in range(3):
        tangent = torch.zeros_like(p_c)
        tangent[:, k] = 1.0
        pred, col = torch.func.jvp(proj, (p_c,), (tangent,))
        cols.append(col)
    return pred, torch.stack(cols, dim=-1)


def _obs_residual_jac(cam_name, prob: BAProblem, poses, points):
    """Residuals [O, 2] and Jacobians wrt camera delta [O, 2, 6] and point
    [O, 2, 3]: with the retraction T*exp(delta), dp_c/d[ups, omega] =
    [-I | hat(p_c)] and dp_c/dX = R_cw; r = uv - proj flips the signs."""
    p_c, Rg, intr = _obs_p_c(prob, poses, points)
    pred, Jproj = project_jacobian(cam_name, intr, p_c)
    raw = prob.obs_uv - pred
    r = torch.clamp(raw, -RESIDUAL_CLIP, RESIDUAL_CLIP)
    # a clipped residual component has zero derivative
    inside = (torch.abs(raw) < RESIDUAL_CLIP).to(r.dtype)[..., None]
    Jproj = Jproj * inside
    Jc = torch.cat(
        [Jproj, -torch.einsum("oij,ojk->oik", Jproj, lie.hat(p_c))], dim=-1)
    Jp = -torch.einsum("oij,ojk->oik", Jproj, Rg)
    return r, Jc, Jp


def _huber_weights(r, huber):
    """Per-observation IRLS sqrt-weights for blockwise Huber on ||r||."""
    nrm = torch.linalg.norm(r, dim=-1)
    w = torch.clamp(huber / torch.clamp(nrm, min=1e-12), max=1.0)
    return torch.sqrt(w)


def _robust_cost(r, valid, huber):
    """Total Huber cost (Ceres' 0.5 * sum rho up to the 0.5)."""
    s = torch.sum(r * r, dim=-1)
    nrm = torch.sqrt(torch.clamp(s, min=0.0))
    rho = torch.where(nrm <= huber, s, 2.0 * huber * nrm - huber * huber)
    return torch.sum(torch.where(valid, rho, torch.zeros_like(rho)))


def _normal_equations(cam_name, prob: BAProblem, poses, points, huber):
    """Build H_cc [K,6,6], H_pp [L,3,3], U [K,6,L,3], b_c [K,6], b_p [L,3]."""
    K = poses.shape[0]
    L = points.shape[0]
    r, Jc, Jp = _obs_residual_jac(cam_name, prob, poses, points)
    r, Jc, Jp = _sanitize(r), _sanitize(Jc), _sanitize(Jp)
    sw = _huber_weights(r, huber) * prob.obs_valid.to(r.dtype)
    r = r * sw[:, None]
    Jc = Jc * sw[:, None, None]
    Jp = Jp * sw[:, None, None]

    Hcc_o = torch.einsum("oia,oib->oab", Jc, Jc)      # [O, 6, 6]
    Hpp_o = torch.einsum("oia,oib->oab", Jp, Jp)      # [O, 3, 3]
    W_o = torch.einsum("oia,oib->oab", Jc, Jp)        # [O, 6, 3]
    bc_o = torch.einsum("oia,oi->oa", Jc, r)          # [O, 6]
    bp_o = torch.einsum("oia,oi->oa", Jp, r)          # [O, 3]

    O_ = r.shape[0]
    cam = prob.obs_cam.long()
    pt = prob.obs_point.long()
    cam_pack = _segment_sum(torch.cat([Hcc_o.reshape(O_, 36), bc_o], 1),
                            cam, K)
    Hcc, bc = cam_pack[:, :36].reshape(K, 6, 6), cam_pack[:, 36:]
    pt_pack = _segment_sum(torch.cat([Hpp_o.reshape(O_, 9), bp_o], 1), pt, L)
    Hpp, bp = pt_pack[:, :9].reshape(L, 3, 3), pt_pack[:, 9:]
    # densify W into U [K, 6, L, 3] via a segment over (cam, point) pairs
    U = _segment_sum(W_o, cam * L + pt, K * L)
    U = U.reshape(K, L, 6, 3).permute(0, 2, 1, 3)
    return Hcc, Hpp, U, bc, bp, r


def _schur_solve(Hcc, Hpp, U, bc, bp, pose_fixed, point_valid, lam):
    """Solve the damped normal equations by eliminating points."""
    K = Hcc.shape[0]
    L = Hpp.shape[0]
    eye3 = torch.eye(3, dtype=Hcc.dtype, device=Hcc.device)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    pv = point_valid[:, None, None]

    # LM damping (lam * I, plus a floor for empty blocks); invalid points
    # get an identity block so the 3x3 inverses stay finite
    Hpp_d = torch.where(pv, Hpp + (lam + 1e-8) * eye3, eye3)
    Hpp_inv = torch.where(pv, torch.linalg.inv_ex(Hpp_d)[0],
                          torch.zeros_like(Hpp_d))

    # S = Hcc - U Hpp^-1 U^T as one [6K, 3L] @ [3L, 6K] product
    T1 = torch.einsum("kalb,lbc->kalc", U, Hpp_inv)   # [K, 6, L, 3]
    S = -(T1.reshape(6 * K, 3 * L) @ U.reshape(6 * K, 3 * L).T)
    S = S.reshape(K, 6, K, 6)
    S.diagonal(0, 0, 2).add_((Hcc + lam * eye6).permute(1, 2, 0))
    S = S.reshape(6 * K, 6 * K)
    rhs = -(bc - torch.einsum("kalb,lb->ka", T1, bp)).reshape(6 * K)

    # gauge fixing: zero rows/cols of fixed cameras, identity diagonal
    free = (~pose_fixed).repeat_interleave(6)
    S = torch.where(free[:, None] & free[None, :], S, torch.zeros_like(S))
    S = S + torch.diag((~free).to(S.dtype))
    rhs = torch.where(free, rhs, torch.zeros_like(rhs))
    # nan_to_num guards singular systems (the LM accept test then rejects
    # the step)
    delta_c = torch.nan_to_num(
        torch.linalg.solve_ex(S, rhs)[0]).reshape(K, 6)

    # back-substitute points: delta_p = Hpp^-1 (-bp - U^T delta_c)
    rhs_p = -bp - torch.einsum("kalb,ka->lb", U, delta_c)
    delta_p = torch.einsum("lab,lb->la", Hpp_inv, rhs_p)
    delta_p = torch.where(point_valid[:, None], delta_p,
                          torch.zeros_like(delta_p))
    return delta_c, delta_p


def _lm_gain_update(cost, new_cost, lam, nu, pred, step_inf,
                    step_cap: float, ftol: float):
    """Gain-ratio LM damping control. A step is accepted only when the
    actual reduction is positive, the gain ratio against the damped model
    is positive, and the step is finite and bounded.

    Returns (accept, converged, lam_new, nu_new)."""
    actual = cost - new_cost
    rho = actual / torch.clamp(pred, min=1e-20)
    sane = torch.isfinite(new_cost) & (step_inf < step_cap)
    accept = (actual > 0) & (rho > 1e-3) & sane
    converged = accept & (actual <= ftol * torch.abs(cost))
    fac = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_new = torch.where(accept, lam * fac, lam * nu)
    nu_new = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    return (accept, converged, torch.clamp(lam_new, 1e-9, 1e8),
            torch.clamp(nu_new, max=64.0))


def solve_ba_schur(prob: BAProblem, cam_name: str = "ds", huber=1.0,
                   max_iters: int = 20, lam0: float = 1e-4,
                   step_cap: float = 10.0):
    """LM bundle adjustment with explicit Schur elimination.

    Returns (poses [K,7], points [L,3], stats dict of 0-dim tensors and the
    iteration count).
    """
    ftol = 1e-6   # Ceres-style function tolerance
    gtol = 0.05   # relative gradient tolerance

    def cost_of(poses, points):
        return _robust_cost(_residuals(cam_name, prob, poses, points),
                            prob.obs_valid, huber)

    dtype, dev = prob.poses.dtype, prob.poses.device
    free_c = (~prob.pose_fixed)[:, None].to(dtype)
    free_p = prob.point_valid[:, None].to(dtype)
    fixed = prob.pose_fixed[:, None]
    poses, points = prob.poses, prob.points
    lam = torch.tensor(lam0, dtype=dtype, device=dev)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    init_cost = cost = cost_of(poses, points)
    iters = 0
    while iters < max_iters:
        Hcc, Hpp, U, bc, bp, _ = _normal_equations(cam_name, prob, poses,
                                                   points, huber)
        # gradient termination: at a (local) optimum every step is
        # rejected, so exit instead of ratcheting lambda up to the limit
        g_inf = torch.maximum(torch.max(torch.abs(bc) * free_c),
                              torch.max(torch.abs(bp) * free_p))
        done_grad = g_inf <= gtol * (1.0 + cost)
        dc, dp = _schur_solve(Hcc, Hpp, U, bc, bp, prob.pose_fixed,
                              prob.point_valid, lam)
        new_poses = torch.where(fixed, poses, lie.se3_retract(poses, dc))
        new_points = points + dp
        new_cost = cost_of(new_poses, new_points)
        # gain ratio vs the damped model: pred = 0.5*(lam*||d||^2 - b.d)
        dcf = dc * free_c
        dpf = dp * free_p
        d_sq = torch.sum(dcf * dcf) + torch.sum(dpf * dpf)
        b_dot = torch.sum(bc * dcf) + torch.sum(bp * dpf)
        pred = 0.5 * (lam * d_sq - b_dot)
        step_inf = torch.max(torch.abs(dcf))
        accept, converged, lam, nu = _lm_gain_update(
            cost, new_cost, lam, nu, pred, step_inf, step_cap, ftol)
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        cost = torch.where(accept, new_cost, cost)
        iters += 1
        # a rejected step with huge lambda means we are stuck
        stuck = ~accept & (lam >= 1e8)
        if bool(converged | stuck | done_grad):
            break
    stats = {"initial_cost": init_cost, "final_cost": cost, "lambda": lam,
             "iterations": iters}
    return poses, points, stats
