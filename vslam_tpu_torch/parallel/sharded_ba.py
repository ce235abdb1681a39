"""Global bundle adjustment with the observations sharded over a mesh.

Port of ``vslam_tpu/parallel/sharded_ba.py``: the matrix-free LM-CG solver
(``solvers/ba_cg.py``) is map / reduce over the observation axis, so the
observation arrays are split over the mesh's 'data' axis and poses, points,
intrinsics and masks are replicated (they are tiny next to the
observations). The reference leaves the reductions to its compiler; here
``solve_ba_cg`` sums the shards' partial results on the lead device (the
first of the mesh) and sends the CG vectors back out.
"""

from __future__ import annotations

import torch

from ..solvers import ba_cg
from ..solvers.ba import BAProblem
from .mesh import Mesh


def shard_problem(prob: BAProblem, mesh: Mesh) -> list:
    """One ``BAProblem`` per device of the 'data' axis: a contiguous slice
    of the observation arrays (sizes differ by at most one) and a replica
    of everything else, on that device."""
    devs = mesh.axis_devices("data")
    n = len(devs)
    obs = {name: torch.tensor_split(getattr(prob, name), n)
           for name in ("obs_cam", "obs_point", "obs_uv", "obs_valid")}
    return [BAProblem(
        poses=prob.poses.to(d), pose_fixed=prob.pose_fixed.to(d),
        intr=prob.intr.to(d), points=prob.points.to(d),
        point_valid=prob.point_valid.to(d),
        **{name: parts[i].to(d) for name, parts in obs.items()})
        for i, d in enumerate(devs)]


def solve_sharded(prob: BAProblem, mesh: Mesh, cam_name: str = "ds",
                  **kwargs):
    """Shard + solve; poses, points and stats come back on the mesh's first
    device."""
    return ba_cg.solve_ba_cg(shard_problem(prob, mesh), cam_name=cam_name,
                             **kwargs)
