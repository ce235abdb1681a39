"""Matrix-free LM-CG pose graph optimization for large graphs.

Port of ``vslam_tpu/solvers/pose_graph_cg.py``. The dense assembly in
``solvers/pose_graph.py`` builds a (6K, 6K) system, fine to about a
thousand keyframes; this variant never forms the Hessian: conjugate
gradients run on ``H v = J^T (J v) + lam v``, memory O(K + E).

The reference takes ``J v`` and ``J^T u`` as jvp / vjp calls through the
weighted edge residuals. With the Huber weights frozen per LM iteration
and the residual linearised at zero, those are exactly products with the
per-edge 6x6 blocks of ``pose_graph._edge_blocks``, so the blocks are
computed once per LM iteration and each CG iteration is two gathers, two
batched products and two ``index_add_``. As in the reference there is no
early exit: ``max_iters`` LM iterations of ``cg_iters`` CG iterations, and
no host read anywhere.
"""

from __future__ import annotations

import torch

from ..geometry import lie
from .ba import _lm_gain_update, _sanitize
from .pose_graph import PoseGraphProblem, _edge_blocks, _robust_cost


def solve_pose_graph_cg(prob: PoseGraphProblem, huber: float = 1.0,
                        max_iters: int = 20, cg_iters: int = 30,
                        lam0: float = 1e-6):
    """Returns (poses [K, 7], stats). Same semantics as solve_pose_graph;
    ``stats["history"]`` is the trial cost of every LM iteration."""
    K = prob.poses.shape[0]
    dtype, dev = prob.poses.dtype, prob.poses.device
    free = (~prob.fixed)[:, None].to(dtype)
    fixed = prob.fixed[:, None]
    ei, ej = prob.edge_i.long(), prob.edge_j.long()

    poses = prob.poses
    lam = torch.tensor(lam0, dtype=dtype, device=dev)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    init_cost = cost = _robust_cost(poses, prob, huber)
    history = []
    for _ in range(max_iters):
        r, Ji, Jj = (_sanitize(x) for x in _edge_blocks(poses, prob, huber))

        def JTu(u):
            out = torch.zeros((K, 6), dtype=dtype, device=dev)
            out.index_add_(0, ei, torch.einsum("eri,er->ei", Ji, u))
            out.index_add_(0, ej, torch.einsum("eri,er->ei", Jj, u))
            return out * free

        def Hv(v):
            vf = v * free
            Jv = (torch.einsum("eri,ei->er", Ji, vf[ei])
                  + torch.einsum("eri,ei->er", Jj, vf[ej]))
            return JTu(Jv) + lam * vf

        g = JTu(r)
        b = -g
        # plain CG from zero
        x = torch.zeros_like(b)
        res, p = b, b
        rs = torch.sum(b * b)
        for _ in range(cg_iters):
            Ap = Hv(p)
            alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-30)
            x = x + alpha * p
            res = res - alpha * Ap
            rs_new = torch.sum(res * res)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            p = res + beta * p
            rs = rs_new
        delta = x * free

        new_poses = torch.where(fixed, poses, lie.se3_retract(poses, delta))
        new_cost = _robust_cost(new_poses, prob, huber)
        # gain-ratio damping control (see solvers/ba.py _lm_gain_update)
        pred = 0.5 * (lam * torch.sum(delta * delta) - torch.sum(g * delta))
        accept, _, lam, nu = _lm_gain_update(
            cost, new_cost, lam, nu, pred, torch.max(torch.abs(delta)),
            step_cap=50.0, ftol=1e-8)
        poses = torch.where(accept, new_poses, poses)
        cost = torch.where(accept, new_cost, cost)
        history.append(new_cost)
    return poses, {"initial_cost": init_cost, "final_cost": cost,
                   "history": torch.stack(history) if history
                   else torch.zeros((0,), dtype=dtype, device=dev)}
