"""Bundle adjustment over per-landmark observation tables.

Port of ``vslam_tpu/solvers/ba_blocked.py``: the global-BA problem in the
map's natural [L, M] layout (at most M observation slots per landmark),
Levenberg-Marquardt with the landmarks eliminated by an explicit Schur
complement, the same LM control as ``solvers/ba.py``.

The reference aggregates the per-camera blocks (H_cc, b_c, the coupling
U) with one-hot contractions in bfloat16, a TPU layout choice that avoids
scatters. On the card a float32 scatter-add is the natural form, and it is
exactly the flat solver's: so the port takes the valid [L, M] slots as a
flat observation list (camera row, landmark) and runs
``ba.solve_ba_schur``, whose normal equations aggregate per camera and
per landmark with ``index_add_`` in float32 and whose Schur solve is the
reference's (a dense (6K, 6K) reduced camera system, batched 3x3
inverses of the landmark blocks, the CPU branch of ``_inv3x3_auto``).
Residual clipping, Huber weights, damping, ftol/gtol and the stuck exit
are the blocked solver's, which shares them with the flat one.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import TensorState
from . import ba


@dataclasses.dataclass
class BlockProblem(TensorState):
    """BA problem over per-landmark observation tables. K camera rows,
    L landmarks, M observation slots per landmark."""

    poses: torch.Tensor        # [K, 7] T_w_c
    pose_fixed: torch.Tensor   # [K] bool (gauge / inactive)
    intr: torch.Tensor         # [K, 8]
    points: torch.Tensor       # [L, 3]
    point_valid: torch.Tensor  # [L] bool
    obs_cam: torch.Tensor      # [L, M] int32 camera row, any value if invalid
    obs_uv: torch.Tensor       # [L, M, 2]
    obs_valid: torch.Tensor    # [L, M] bool


def flat_problem(prob: BlockProblem) -> ba.BAProblem:
    """The valid slots of the [L, M] tables as a flat observation list."""
    lm_idx, slot = torch.nonzero(prob.obs_valid, as_tuple=True)
    return ba.BAProblem(
        poses=prob.poses, pose_fixed=prob.pose_fixed, intr=prob.intr,
        points=prob.points, point_valid=prob.point_valid,
        obs_cam=prob.obs_cam[lm_idx, slot].to(torch.int32),
        obs_point=lm_idx.to(torch.int32),
        obs_uv=prob.obs_uv[lm_idx, slot],
        obs_valid=torch.ones_like(lm_idx, dtype=torch.bool))


def solve_ba_blocked(prob: BlockProblem, cam_name: str = "ds", huber=1.0,
                     max_iters: int = 20, lam0: float = 1e-4,
                     step_cap: float = 10.0):
    """LM bundle adjustment, Schur elimination. Returns (poses [K,7],
    points [L,3], stats)."""
    return ba.solve_ba_schur(flat_problem(prob), cam_name=cam_name,
                             huber=huber, max_iters=max_iters, lam0=lam0,
                             step_cap=step_cap, early_exit=True)
