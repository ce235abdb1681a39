"""Matrix-free LM-CG bundle adjustment for large problems.

Port of ``vslam_tpu/solvers/ba_cg.py``. At thousands of keyframes an
explicit reduced camera system stops fitting; this solver never forms the
Hessian: each LM iteration runs conjugate gradients on
``H v = J^T (J v) + lambda v`` over the free camera and point blocks.

The reference takes ``J v`` / ``J^T u`` as jvp / vjp calls through the
weighted residual function and reduces with a sorted, gather-based segment
sum (its accelerator serialises scatter-adds). With the Huber weights
frozen per LM iteration and the residual linearised at zero, those
products are exactly products with the per-observation blocks that
``ba._obs_residual_jac`` gives, so here the blocks ``[O, 2, 6]`` and
``[O, 2, 3]`` are computed once per LM iteration and each CG iteration is
two gathers, small batched products and two ``index_add_`` (atomic sums on
the card: the last bits vary from run to run unless PyTorch's
deterministic algorithms are on).

Gauge fixing masks the fixed cameras' and invalid points' blocks inside
the operator. The reference's ``lax.while_loop`` is a host loop with the
same function tolerance, gradient tolerance and stuck exit: one host read
of the exit flag per LM iteration, none inside the CG loop.
"""

from __future__ import annotations

import torch

from ..geometry import lie
from .ba import (BAProblem, _huber_weights, _lm_gain_update,
                 _obs_residual_jac, _residuals, _robust_cost, _sanitize,
                 _segment_sum)


def solve_ba_cg(prob: BAProblem, cam_name: str = "ds", huber=1.0,
                max_iters: int = 15, cg_iters: int = 25, lam0: float = 1e-3):
    """LM with inner CG. Returns (poses [K,7], points [L,3], stats dict of
    0-dim tensors, the LM iteration count and the CG iterations run)."""
    ftol = 1e-6
    gtol = 0.05   # relative gradient tolerance (same scale as solvers/ba.py)
    step_cap = 10.0

    K, L = prob.poses.shape[0], prob.points.shape[0]
    dtype, dev = prob.poses.dtype, prob.poses.device
    free_c = (~prob.pose_fixed)[:, None].to(dtype)       # [K, 1]
    free_p = prob.point_valid[:, None].to(dtype)         # [L, 1]
    fixed = prob.pose_fixed[:, None]
    cam, pt = prob.obs_cam.long(), prob.obs_point.long()
    obs_w = prob.obs_valid.to(dtype)

    def cost_of(poses, points):
        return _robust_cost(_residuals(cam_name, prob, poses, points),
                            prob.obs_valid, huber)

    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    poses, points = prob.poses, prob.points
    lam = torch.tensor(lam0, dtype=dtype, device=dev)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    init_cost = cost = cost_of(poses, points)
    iters = 0
    while iters < max_iters:
        r, Jc, Jp = _obs_residual_jac(cam_name, prob, poses, points)
        # non-finite rows (degenerate Jacobians of outliers) contribute zero
        r, Jc, Jp = _sanitize(r), _sanitize(Jc), _sanitize(Jp)
        sw = _huber_weights(r, huber) * obs_w
        r = r * sw[:, None]
        Jc = Jc * sw[:, None, None]
        Jp = Jp * sw[:, None, None]

        def JTu(u):
            return (_segment_sum(torch.einsum("oia,oi->oa", Jc, u), cam, K)
                    * free_c,
                    _segment_sum(torch.einsum("oia,oi->oa", Jp, u), pt, L)
                    * free_p)

        def Hv(v):
            vc, vp = v[0] * free_c, v[1] * free_p
            Jv = (torch.einsum("oia,oa->oi", Jc, vc[cam])
                  + torch.einsum("oia,oa->oi", Jp, vp[pt]))
            hc, hp = JTu(Jv)
            return hc + lam * vc, hp + lam * vp

        g = JTu(r)
        b = (-g[0], -g[1])
        g_inf = torch.maximum(torch.max(torch.abs(b[0])),
                              torch.max(torch.abs(b[1])))
        done_grad = g_inf <= gtol * (1.0 + cost)

        # plain CG from zero
        x = (torch.zeros_like(b[0]), torch.zeros_like(b[1]))
        res, p = b, b
        rs = dot(b, b)
        for _ in range(cg_iters):
            Ap = Hv(p)
            alpha = rs / torch.clamp(dot(p, Ap), min=1e-30)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            res = (res[0] - alpha * Ap[0], res[1] - alpha * Ap[1])
            rs_new = dot(res, res)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            p = (res[0] + beta * p[0], res[1] + beta * p[1])
            rs = rs_new
        dc, dp = x[0] * free_c, x[1] * free_p

        new_poses = torch.where(fixed, poses, lie.se3_retract(poses, dc))
        new_points = points + dp
        new_cost = cost_of(new_poses, new_points)
        # gain ratio vs the damped model: pred = 0.5*(lam*||d||^2 - b.d)
        pred = 0.5 * (lam * dot((dc, dp), (dc, dp)) - dot(g, (dc, dp)))
        step_inf = torch.max(torch.abs(dc))
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
             "iterations": iters, "cg_iterations": iters * cg_iters}
    return poses, points, stats


# The reference splits the same solve into one device program per LM
# iteration (its runtime faulted on very long programs) with identical
# results; an eager host loop already runs that way.
solve_ba_cg_stepped = solve_ba_cg
