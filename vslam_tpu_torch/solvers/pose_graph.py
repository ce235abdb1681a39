"""Pose graph optimization: LM on SE3 relative-pose residuals.

Port of ``vslam_tpu/solvers/pose_graph.py`` (the reference's Ceres
essential-graph solve after loop closure, loop_closure_utils.h:446-587):
residual ``log(T_i^-1 T_j) - meas`` per edge, blockwise Huber, fixed
keyframes held by identity rows, per-edge 6x6 blocks summed into a dense
(6K, 6K) system.

The edge Jacobians with respect to the right-multiplicative retractions
``T_i exp(d_i)``, ``T_j exp(d_j)`` at zero are forward-mode derivatives,
as the reference takes them with ``jax.jacfwd``: one ``torch.func.jvp``
over all edges per tangent direction, the twelve directions batched with
``torch.func.vmap``. The reference's ``lax.while_loop`` is a host loop with
one read of the exit flag per iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import TensorState
from ..geometry import lie
from .ba import _lm_gain_update


@dataclasses.dataclass
class PoseGraphProblem(TensorState):
    poses: torch.Tensor       # [K, 7] T_w_c
    fixed: torch.Tensor       # [K] bool
    edge_i: torch.Tensor      # [E] int
    edge_j: torch.Tensor      # [E] int
    edge_meas: torch.Tensor   # [E, 6] log(T_i^-1 T_j) measurement
    edge_valid: torch.Tensor  # [E] bool


def _edge_residual(Ti, Tj, meas):
    return lie.se3_log(lie.se3_mul(lie.se3_inv(Ti), Tj)) - meas


def _edge_blocks(poses, prob: PoseGraphProblem, huber: float):
    """Residuals [E, 6] and Jacobians [E, 6, 6] x2 per edge, with the
    Huber IRLS sqrt-weights folded in."""
    Ti = poses[prob.edge_i.long()]
    Tj = poses[prob.edge_j.long()]
    meas = prob.edge_meas

    def r_of(di, dj):
        return _edge_residual(lie.se3_retract(Ti, di),
                              lie.se3_retract(Tj, dj), meas)

    z = torch.zeros(Ti.shape[0], 6, dtype=poses.dtype, device=poses.device)
    r = r_of(z, z)
    # tangent k (of 12) is the unit step of parameter k at every edge
    basis = torch.eye(12, dtype=poses.dtype, device=poses.device)
    tangents = basis[:, None, :].expand(12, Ti.shape[0], 12)

    def column(t):
        return torch.func.jvp(r_of, (z, z), (t[:, :6], t[:, 6:]))[1]

    cols = torch.func.vmap(column)(tangents)          # [12, E, 6]
    J = cols.permute(1, 2, 0)                         # [E, 6, 12]
    Ji, Jj = J[..., :6], J[..., 6:]
    nrm = torch.linalg.norm(r, dim=-1)
    w = torch.clamp(huber / torch.clamp(nrm, min=1e-12), max=1.0)
    sw = torch.sqrt(w) * prob.edge_valid.to(r.dtype)
    return r * sw[:, None], Ji * sw[:, None, None], Jj * sw[:, None, None]


def _robust_cost(poses, prob: PoseGraphProblem, huber: float):
    r = _edge_residual(poses[prob.edge_i.long()], poses[prob.edge_j.long()],
                       prob.edge_meas)
    s = torch.sum(r * r, dim=-1)
    nrm = torch.sqrt(torch.clamp(s, min=0.0))
    rho = torch.where(nrm <= huber, s, 2.0 * huber * nrm - huber * huber)
    return torch.sum(torch.where(prob.edge_valid, rho, torch.zeros_like(rho)))


def _build_system(poses, prob: PoseGraphProblem, huber: float):
    """Dense H [6K, 6K] and g [6K] of the weighted edges."""
    K = poses.shape[0]
    r, Ji, Jj = _edge_blocks(poses, prob, huber)
    Hii = torch.einsum("eri,erj->eij", Ji, Ji)
    Hjj = torch.einsum("eri,erj->eij", Jj, Jj)
    Hij = torch.einsum("eri,erj->eij", Ji, Jj)
    gi = torch.einsum("eri,er->ei", Ji, r)
    gj = torch.einsum("eri,er->ei", Jj, r)
    i, j = prob.edge_i.long(), prob.edge_j.long()
    blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
    pairs = torch.cat([i * K + i, j * K + j, i * K + j, j * K + i])
    H = poses.new_zeros((K * K, 6, 6)).index_add_(0, pairs, blocks)
    H = H.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    g = poses.new_zeros((K, 6)).index_add_(0, i, gi).index_add_(0, j, gj)
    return H, g.reshape(6 * K)


def solve_pose_graph(prob: PoseGraphProblem, huber: float = 1.0,
                     max_iters: int = 20, lam0: float = 1e-6):
    """Returns (poses [K, 7], stats)."""
    K = prob.poses.shape[0]
    dtype, dev = prob.poses.dtype, prob.poses.device
    free = (~prob.fixed).repeat_interleave(6)
    free2 = free[:, None] & free[None, :]
    eye = torch.eye(6 * K, dtype=dtype, device=dev)
    pin = torch.diag((~free).to(dtype))
    fixed = prob.fixed[:, None]
    ftol = 1e-8
    gtol = 1e-4  # pose-graph residuals are rad/m scale (not pixels)

    poses = prob.poses
    lam = torch.tensor(lam0, dtype=dtype, device=dev)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    init_cost = cost = _robust_cost(poses, prob, huber)
    iters = 0
    while iters < max_iters:
        H, g = _build_system(poses, prob, huber)
        g_free = torch.where(free, g, torch.zeros_like(g))
        done_grad = torch.max(torch.abs(g_free)) <= gtol * (1.0 + cost)
        H = torch.where(free2, H + lam * eye, torch.zeros_like(H)) + pin
        rhs = -g_free
        delta_f = torch.nan_to_num(torch.linalg.solve_ex(H, rhs)[0])
        new_poses = torch.where(
            fixed, poses, lie.se3_retract(poses, delta_f.reshape(K, 6)))
        new_cost = _robust_cost(new_poses, prob, huber)
        # gain-ratio damping control (see solvers/ba.py _lm_gain_update)
        pred = 0.5 * (lam * torch.sum(delta_f * delta_f)
                      - torch.sum(g_free * delta_f))
        step_inf = torch.max(torch.abs(delta_f))
        accept, converged, lam, nu = _lm_gain_update(
            cost, new_cost, lam, nu, pred, step_inf, step_cap=50.0,
            ftol=ftol)
        poses = torch.where(accept, new_poses, poses)
        cost = torch.where(accept, new_cost, cost)
        iters += 1
        stuck = ~accept & (lam >= 1e8)
        if bool(converged | stuck | done_grad):
            break
    return poses, {"initial_cost": init_cost, "final_cost": cost,
                   "iterations": iters}
