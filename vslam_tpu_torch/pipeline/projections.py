"""Reprojection reporting: per-observation errors + outlier flags.

Port of ``vslam_tpu/pipeline/projections.py``: the reference's
``compute_projections`` cache (slam.cpp:1461-1507 filling ImageProjections
with per-observation reprojection errors and OutlierFlags,
common_types.h:313-353), which feeds both the GUI overlays and outlier
inspection. One pass over the landmarks' observation tables, compacted to
a fixed ``O`` rows, returning flat tensors a caller can aggregate per
keyframe or feed to ``viz.overlays.draw_reprojections``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.state import KeyframeState, LandmarkState
from ..geometry import cameras as cam_models
from ..geometry import lie
from ..ops.compact import compact_indices

# OutlierFlags semantics (common_types.h:314-324)
OUTLIER_NONE = 0
OUTLIER_REPROJECTION_HUGE = 1 << 0    # error much too large
OUTLIER_REPROJECTION_NORMAL = 1 << 1  # error too large
OUTLIER_CAMERA_DISTANCE = 1 << 2      # too close to the camera
OUTLIER_Z_COORDINATE = 1 << 3         # z in camera frame too small


@dataclasses.dataclass
class ProjectionReport:
    obs_kf: torch.Tensor         # [O] keyframe slot (-1 padding)
    obs_cam: torch.Tensor        # [O]
    obs_lm: torch.Tensor         # [O] landmark slot
    measured: torch.Tensor       # [O, 2]
    projected: torch.Tensor      # [O, 2]
    error: torch.Tensor          # [O] reprojection error (px)
    outlier_flags: torch.Tensor  # [O] int32 bitmask
    valid: torch.Tensor          # [O] bool


def compute_projections(
    kf: KeyframeState,
    lm: LandmarkState,
    intr0,
    intr1,
    cam_name: str = "ds",
    O: int = 20480,
    huge_px: float = 8.0,
    normal_px: float = 3.0,
    min_distance: float = 0.1,
    z_threshold: float = 0.1,
) -> ProjectionReport:
    L, M = lm.obs_kf.shape
    dev = lm.obs_kf.device
    flat_kf = lm.obs_kf.reshape(-1)
    flat_cam = lm.obs_cam.reshape(-1)
    flat_feat = lm.obs_feat.reshape(-1)
    flat_lm = torch.arange(L, dtype=torch.int32,
                           device=dev).repeat_interleave(M)
    flat_valid = (flat_kf >= 0) & (lm.valid & lm.active).repeat_interleave(M)

    sel, sel_ok = compact_indices(flat_valid, O)
    sel = torch.clamp(sel, 0, flat_valid.shape[0] - 1)
    o_valid = flat_valid[sel] & sel_ok
    o_kf = torch.clamp(flat_kf[sel], min=0).long()
    o_cam = flat_cam[sel]
    o_feat = flat_feat[sel].long()
    o_lm = flat_lm[sel]

    left = (o_cam == 0)[:, None]
    T = torch.where(left, kf.pose_l[o_kf], kf.pose_r[o_kf])
    X = lm.pos[o_lm.long()]
    p_c = lie.se3_apply(lie.se3_inv(T), X)
    intr = torch.where(left, intr0[None, :], intr1[None, :])
    proj = cam_models.project(cam_name, intr, p_c)
    measured = kf.corners[o_kf, o_cam.long(), o_feat]
    err = torch.linalg.vector_norm(measured - proj, dim=-1)

    def flag(cond, bit):
        return torch.where(cond, bit, 0).to(torch.int32)

    dist = torch.linalg.vector_norm(p_c, dim=-1)
    flags = (flag(err > huge_px, OUTLIER_REPROJECTION_HUGE)
             | flag(err > normal_px, OUTLIER_REPROJECTION_NORMAL)
             | flag(dist < min_distance, OUTLIER_CAMERA_DISTANCE)
             | flag(p_c[:, 2] < z_threshold, OUTLIER_Z_COORDINATE))

    return ProjectionReport(
        obs_kf=torch.where(o_valid, o_kf.to(torch.int32),
                           torch.full_like(o_kf, -1, dtype=torch.int32)),
        obs_cam=o_cam, obs_lm=o_lm,
        measured=measured, projected=proj,
        error=torch.where(o_valid, err, torch.zeros_like(err)),
        outlier_flags=torch.where(o_valid, flags, torch.zeros_like(flags)),
        valid=o_valid,
    )


def reprojection_rmse(report: ProjectionReport) -> float:
    e = report.error[report.valid].detach().cpu().numpy()
    return float(np.sqrt(np.mean(e * e))) if len(e) else float("nan")
