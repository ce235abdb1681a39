"""Bundle adjustment: Levenberg-Marquardt with an explicit Schur complement.

Port of ``vslam_tpu/solvers/ba.py``: ``solve_ba_schur`` with its dense
branch (``_normal_equations`` + ``_schur_solve``), and
``solve_ba_schur_intrinsics``, which frees the two shared intrinsics
blocks as well (camera row k uses block k % 2; the 16 parameters join the
reduced camera system after the points are eliminated). Residual
``r = uv - project(T_w_c^-1 X)`` per observation, blockwise Huber IRLS
weights, SE3 right-multiplicative updates, gauge fixed by frozen cameras,
and the landmark block eliminated explicitly (batched 3x3 inverses, the
coupling densified to U [K, 6, L, 3], a dense (6K, 6K) reduced camera
system).

Pose and point Jacobians are analytic through the SE3 chain; only the
camera projection's Jacobian dproj/dp_c is forward-mode autodiff, taken as
three ``torch.func.jvp`` calls over the whole observation batch (one per
input axis; each output row depends on its own input row only); the
Jacobian with respect to the 8 intrinsics goes the same way, eight more.
``jax.ops.segment_sum`` becomes ``index_add_`` (on the card an atomic sum,
so the summation order, and the last bits, vary from run to run).

The reference's ``lax.while_loop`` runs on the device: its body repeats
until the function tolerance, the gradient tolerance or the stuck exit
holds, or ``max_iters`` bodies have run. Here one LM body (``lm_body``)
reads the loop's state from buffers allocated before the first body
(``LMCarry``: poses, points, cost, damping, iteration count and a device
flag ``done``, set after the body in which an exit first holds) and writes
it back in place; once ``done`` is set a body changes nothing. There are
two loops over it, chosen by whether the card's current stream is being
captured into a CUDA graph:

- eager (the CPU, and the card outside a capture): ``max_iters`` bodies,
  the later ones masked by ``done``; ``early_exit=True`` adds a host read
  of ``done`` after each body and stops there, for eager callers that
  would rather not pay for the masked bodies. The results are the same
  bits either way.
- inside a capture: each of the ``max_iters`` bodies behind a conditional
  IF node on ``not done`` (``ops/cuda_graphs.if_node``), so a replay
  skips the bodies after the exit on the device, with no host read and
  the same bits as the masked loop.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import TensorState
from ..geometry import cameras as cam_models
from ..geometry import lie
from ..ops import cuda_graphs


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


FTOL = 1e-6   # LM function tolerance (Ceres-style)
GTOL = 0.05   # LM relative gradient tolerance
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
        tangent[:, k].fill_(1.0)
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


def _cost(cam_name, prob: BAProblem, poses, points, huber):
    """The robust cost of ``prob`` at poses, points."""
    return _robust_cost(_residuals(cam_name, prob, poses, points),
                        prob.obs_valid, huber)


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


@dataclasses.dataclass
class LMCarry(TensorState):
    """The LM loop's state, carried from body to body in these buffers:
    each body writes them in place (``lm_body``)."""

    poses: torch.Tensor   # [K, 7]
    points: torch.Tensor  # [L, 3]
    cost: torch.Tensor    # [] robust cost at poses, points
    lam: torch.Tensor     # [] damping
    nu: torch.Tensor      # [] damping growth factor
    iters: torch.Tensor   # [] int32 bodies that did work
    done: torch.Tensor    # [] bool an exit has held


def lm_carry(prob: BAProblem, cam_name: str, huber,
             lam0: float) -> LMCarry:
    """The LM loop's state before its first body: ``prob``'s poses and
    points (copied) and their cost, damping ``lam0``."""
    dtype, dev = prob.poses.dtype, prob.poses.device
    return LMCarry(
        poses=prob.poses.clone(), points=prob.points.clone(),
        cost=_cost(cam_name, prob, prob.poses, prob.points, huber),
        lam=torch.full((), lam0, dtype=dtype, device=dev),
        nu=torch.full((), 2.0, dtype=dtype, device=dev),
        iters=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev))


def lm_body(prob: BAProblem, carry: LMCarry, cam_name: str, huber,
            step_cap: float):
    """One LM body of ``solve_ba_schur``, written into ``carry`` in place.
    Its updates hold while ``carry.done`` is unset: the body in which an
    exit first holds applies them, a body after it changes nothing."""
    dtype = prob.poses.dtype
    free_c = (~prob.pose_fixed)[:, None].to(dtype)
    free_p = prob.point_valid[:, None].to(dtype)
    poses, points, cost, lam = carry.poses, carry.points, carry.cost, carry.lam
    Hcc, Hpp, U, bc, bp, _ = _normal_equations(cam_name, prob, poses, points,
                                               huber)
    # gradient termination: at a (local) optimum every step is rejected,
    # so exit instead of ratcheting lambda up to the limit
    g_inf = torch.maximum(torch.max(torch.abs(bc) * free_c),
                          torch.max(torch.abs(bp) * free_p))
    done_grad = g_inf <= GTOL * (1.0 + cost)
    dc, dp = _schur_solve(Hcc, Hpp, U, bc, bp, prob.pose_fixed,
                          prob.point_valid, lam)
    new_poses = torch.where(prob.pose_fixed[:, None], poses,
                            lie.se3_retract(poses, dc))
    new_points = points + dp
    new_cost = _cost(cam_name, prob, new_poses, new_points, huber)
    # gain ratio vs the damped model: pred = 0.5*(lam*||d||^2 - b.d)
    dcf = dc * free_c
    dpf = dp * free_p
    d_sq = torch.sum(dcf * dcf) + torch.sum(dpf * dpf)
    b_dot = torch.sum(bc * dcf) + torch.sum(bp * dpf)
    pred = 0.5 * (lam * d_sq - b_dot)
    step_inf = torch.max(torch.abs(dcf))
    accept, converged, lam_new, nu_new = _lm_gain_update(
        cost, new_cost, lam, carry.nu, pred, step_inf, step_cap, FTOL)
    live = ~carry.done
    take = accept & live
    # a rejected step with huge lambda means we are stuck
    stuck = ~accept & (lam_new >= 1e8)
    updates = ((poses, torch.where(take, new_poses, poses)),
               (points, torch.where(take, new_points, points)),
               (cost, torch.where(take, new_cost, cost)),
               (lam, torch.where(live, lam_new, lam)),
               (carry.nu, torch.where(live, nu_new, carry.nu)),
               (carry.iters, carry.iters + live.to(torch.int32)),
               (carry.done, carry.done | converged | stuck | done_grad))
    for buf, value in updates:
        buf.copy_(value)


def solve_ba_schur(prob: BAProblem, cam_name: str = "ds", huber=1.0,
                   max_iters: int = 20, lam0: float = 1e-4,
                   step_cap: float = 10.0, early_exit: bool = False):
    """LM bundle adjustment with explicit Schur elimination.

    Returns (poses [K,7], points [L,3], stats dict of 0-dim tensors and the
    iteration count: a 0-dim int32 tensor, or an int with
    ``early_exit=True``, module docstring).
    """
    carry = lm_carry(prob, cam_name, huber, lam0)
    init_cost = carry.cost.clone()

    def body():
        lm_body(prob, carry, cam_name, huber, step_cap)

    if prob.poses.is_cuda and torch.cuda.is_current_stream_capturing():
        # inside a CUDA-graph capture: each body behind an IF node on the
        # flag that no exit has held yet
        live = torch.empty_like(carry.done)
        for _ in range(max_iters):
            torch.logical_not(carry.done, out=live)
            with cuda_graphs.if_node(live):
                body()
    else:
        for _ in range(max_iters):
            body()
            if early_exit and bool(carry.done):
                break
    stats = {"initial_cost": init_cost, "final_cost": carry.cost,
             "lambda": carry.lam,
             "iterations": int(carry.iters) if early_exit else carry.iters}
    return carry.poses, carry.points, stats


def _obs_residual_jac_intr(cam_name, prob: BAProblem, poses, points, intr2):
    """Like ``_obs_residual_jac`` with the intrinsics as variables: intr2
    [2, 8] holds the left / right intrinsics and camera row k uses block
    k % 2. Returns (r [O,2], Jc [O,2,6], Jp [O,2,3], Ji [O,2,8])."""
    p_c, Rg, _ = _obs_p_c(prob, poses, points)
    intr = intr2[prob.obs_cam.long() % 2]
    pred, Jproj = project_jacobian(cam_name, intr, p_c)
    cols = []
    for k in range(8):
        tangent = torch.zeros_like(intr)
        tangent[:, k].fill_(1.0)
        cols.append(torch.func.jvp(
            lambda i: cam_models.project(cam_name, i, p_c), (intr,),
            (tangent,))[1])
    Ji_p = torch.stack(cols, dim=-1)                  # [O, 2, 8]
    raw = prob.obs_uv - pred
    r = torch.clamp(raw, -RESIDUAL_CLIP, RESIDUAL_CLIP)
    inside = (torch.abs(raw) < RESIDUAL_CLIP).to(r.dtype)[..., None]
    Jproj = Jproj * inside
    Jc = torch.cat(
        [Jproj, -torch.einsum("oij,ojk->oik", Jproj, lie.hat(p_c))], dim=-1)
    Jp = -torch.einsum("oij,ojk->oik", Jproj, Rg)
    return r, Jc, Jp, -Ji_p * inside


def _normal_equations_intr(cam_name, prob: BAProblem, poses, points, intr2,
                           huber):
    """The ``_normal_equations`` outputs plus the intrinsics blocks
    (Hii [2,8,8], bi [2,8], Hci [K,6,8], Upi [L,2,3,8])."""
    K = poses.shape[0]
    L = points.shape[0]
    r, Jc, Jp, Ji = (_sanitize(x) for x in _obs_residual_jac_intr(
        cam_name, prob, poses, points, intr2))
    sw = _huber_weights(r, huber) * prob.obs_valid.to(r.dtype)
    r = r * sw[:, None]
    Jc, Jp, Ji = (J * sw[:, None, None] for J in (Jc, Jp, Ji))

    def outer(A, B):
        return torch.einsum("oia,oib->oab", A, B)

    def grad(J):
        return torch.einsum("oia,oi->oa", J, r)

    O_ = r.shape[0]
    cam = prob.obs_cam.long()
    pt = prob.obs_point.long()
    iid = cam % 2
    cam_pack = _segment_sum(
        torch.cat([outer(Jc, Jc).reshape(O_, 36), grad(Jc)], 1), cam, K)
    Hcc, bc = cam_pack[:, :36].reshape(K, 6, 6), cam_pack[:, 36:]
    pt_pack = _segment_sum(
        torch.cat([outer(Jp, Jp).reshape(O_, 9), grad(Jp)], 1), pt, L)
    Hpp, bp = pt_pack[:, :9].reshape(L, 3, 3), pt_pack[:, 9:]
    U = _segment_sum(outer(Jc, Jp), cam * L + pt, K * L)
    U = U.reshape(K, L, 6, 3).permute(0, 2, 1, 3)
    Hii = _segment_sum(outer(Ji, Ji), iid, 2)
    bi = _segment_sum(grad(Ji), iid, 2)
    # camera row k couples only with intrinsics block k % 2
    Hci = _segment_sum(outer(Jc, Ji), cam, K)
    Upi = _segment_sum(outer(Jp, Ji), pt * 2 + iid, 2 * L).reshape(L, 2, 3, 8)
    return Hcc, Hpp, U, bc, bp, r, Hii, bi, Hci, Upi


def _schur_solve_intr(Hcc, Hpp, U, bc, bp, Hii, bi, Hci, Upi, pose_fixed,
                      point_valid, lam):
    """Point-eliminated solve of the camera + intrinsics reduced system, a
    dense (6K + 16) system."""
    K = Hcc.shape[0]
    L = Hpp.shape[0]
    dtype, dev = Hcc.dtype, Hcc.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    pv = point_valid[:, None, None]
    Hpp_d = torch.where(pv, Hpp + (lam + 1e-8) * eye3, eye3)
    Hpp_inv = torch.where(pv, torch.linalg.inv_ex(Hpp_d)[0],
                          torch.zeros_like(Hpp_d))

    T1 = torch.einsum("kalb,lbc->kalc", U, Hpp_inv)          # [K, 6, L, 3]
    S = -(T1.reshape(6 * K, 3 * L) @ U.reshape(6 * K, 3 * L).T)
    S = S.reshape(K, 6, K, 6)
    S.diagonal(0, 0, 2).add_((Hcc + lam * eye6).permute(1, 2, 0))

    # camera-intrinsics coupling: the direct term on block k % 2, the
    # point-mediated term on both blocks
    S_ci = -torch.einsum("kalb,lmbe->kame", T1, Upi)         # [K, 6, 2, 8]
    ks = torch.arange(K, device=dev)
    S_ci[ks, :, ks % 2, :] += Hci

    Y = torch.einsum("lbc,lnce->lbne", Hpp_inv, Upi)         # [L, 3, 2, 8]
    S_ii = -torch.einsum("lmbe,lbnf->menf", Upi, Y)          # [2, 8, 2, 8]
    S_ii.diagonal(0, 0, 2).add_(
        (Hii + lam * torch.eye(8, dtype=dtype, device=dev)).permute(1, 2, 0))

    y = torch.einsum("lbc,lc->lb", Hpp_inv, bp)
    rhs_c = -(bc - torch.einsum("kalb,lb->ka", T1, bp))
    rhs_i = -(bi - torch.einsum("lmbe,lb->me", Upi, y))

    free = (~pose_fixed).repeat_interleave(6)
    Sf = S.reshape(6 * K, 6 * K)
    Sf = torch.where(free[:, None] & free[None, :], Sf, torch.zeros_like(Sf))
    Sf = Sf + torch.diag((~free).to(dtype))
    Cf = S_ci.reshape(6 * K, 16) * free[:, None].to(dtype)
    A = torch.cat([torch.cat([Sf, Cf], 1),
                   torch.cat([Cf.T, S_ii.reshape(16, 16)], 1)], 0)
    rhs = torch.cat([rhs_c.reshape(-1) * free.to(dtype), rhs_i.reshape(-1)])
    delta = torch.nan_to_num(torch.linalg.solve_ex(A, rhs)[0])
    delta_c = delta[:6 * K].reshape(K, 6)
    delta_i = delta[6 * K:].reshape(2, 8)

    rhs_p = (-bp - torch.einsum("kalb,ka->lb", U, delta_c)
             - torch.einsum("lmbe,me->lb", Upi, delta_i))
    delta_p = torch.einsum("lab,lb->la", Hpp_inv, rhs_p)
    delta_p = torch.where(point_valid[:, None], delta_p,
                          torch.zeros_like(delta_p))
    return delta_c, delta_p, delta_i


def solve_ba_schur_intrinsics(prob: BAProblem, cam_name: str = "ds",
                              huber=1.0, max_iters: int = 20,
                              lam0: float = 1e-4, early_exit: bool = False):
    """LM bundle adjustment that also optimizes the two shared intrinsics
    blocks (the reference's BundleAdjustmentOptions.optimize_intrinsics).
    ``prob.intr`` rows 0 and 1 give the starting left / right intrinsics.

    Returns (poses [K,7], points [L,3], intr2 [2,8], stats). The masked
    loop, exits and ``early_exit`` of ``solve_ba_schur``'s eager loop (in
    a capture too: no IF nodes).
    """
    ftol, gtol, step_cap = 1e-6, 0.05, 10.0
    cam2 = prob.obs_cam.long() % 2

    def cost_of(poses, points, intr2):
        p_c, _, _ = _obs_p_c(prob, poses, points)
        pred = cam_models.project(cam_name, intr2[cam2], p_c)
        r = torch.clamp(prob.obs_uv - pred, -RESIDUAL_CLIP, RESIDUAL_CLIP)
        return _robust_cost(r, prob.obs_valid, huber)

    dtype, dev = prob.poses.dtype, prob.poses.device
    free_c = (~prob.pose_fixed)[:, None].to(dtype)
    free_p = prob.point_valid[:, None].to(dtype)
    fixed = prob.pose_fixed[:, None]
    poses, points = prob.poses, prob.points
    intr2 = torch.stack([prob.intr[0], prob.intr[1]])
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    init_cost = cost = cost_of(poses, points, intr2)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        (Hcc, Hpp, U, bc, bp, _, Hii, bi, Hci, Upi) = _normal_equations_intr(
            cam_name, prob, poses, points, intr2, huber)
        g_inf = torch.maximum(
            torch.maximum(torch.max(torch.abs(bc) * free_c),
                          torch.max(torch.abs(bp) * free_p)),
            torch.max(torch.abs(bi)))
        done_grad = g_inf <= gtol * (1.0 + cost)
        dc, dp, di = _schur_solve_intr(Hcc, Hpp, U, bc, bp, Hii, bi, Hci, Upi,
                                       prob.pose_fixed, prob.point_valid, lam)
        new_poses = torch.where(fixed, poses, lie.se3_retract(poses, dc))
        new_points = points + dp
        new_intr = intr2 + di
        new_cost = cost_of(new_poses, new_points, new_intr)
        dcf = dc * free_c
        dpf = dp * free_p
        d_sq = torch.sum(dcf * dcf) + torch.sum(dpf * dpf) + torch.sum(di * di)
        b_dot = (torch.sum(bc * dcf) + torch.sum(bp * dpf)
                 + torch.sum(bi * di))
        pred = 0.5 * (lam * d_sq - b_dot)
        step_inf = torch.max(torch.abs(dcf))
        accept, converged, lam_new, nu_new = _lm_gain_update(
            cost, new_cost, lam, nu, pred, step_inf, step_cap, ftol)
        live = ~done
        take = accept & live
        poses = torch.where(take, new_poses, poses)
        points = torch.where(take, new_points, points)
        intr2 = torch.where(take, new_intr, intr2)
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(live, lam_new, lam)
        nu = torch.where(live, nu_new, nu)
        iters = iters + live.to(torch.int32)
        stuck = ~accept & (lam_new >= 1e8)
        done = done | converged | stuck | done_grad
        if early_exit and bool(done):
            break
    stats = {"initial_cost": init_cost, "final_cost": cost, "lambda": lam,
             "iterations": int(iters) if early_exit else iters}
    return poses, points, intr2, stats
