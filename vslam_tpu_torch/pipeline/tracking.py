"""Per-frame tracking.

Port of ``vslam_tpu/pipeline/tracking.py`` (the non-keyframe path of the
reference's ``next_step``): project landmarks, detect + describe the left
image, guided 2D-gated landmark matching, RANSAC PnP localization and the
constant-velocity motion-gate statistic. The L-capacity landmark arrays
are projected in one shot and the in-view subset is compacted to a fixed
P slots (newest first), so the matcher sees fixed [N] x [P, B] shapes.

Over a sequence axis. ``track_frame`` also takes S sequences at once, the
lockstep frame of ``parallel/multiseq_runner.py``: images [S, H, W], a
``LandmarkState`` whose fields lead with S, poses and velocities [S, 7]
(the intrinsics are shared). Every stage then runs once over all S: the
frontend and the compaction carry the axis through, the bank is gathered
per sequence, the guided matching is one launch of the landmark top-2
kernel with the sequence axis on its grid, and the RANSAC PnP is
``torch.func.vmap`` of the single-problem solver. Row s of every result is
what the call on sequence s alone gives, given the same RANSAC draws
(``sample_idx`` [S, H, 6]); the floating-point sums of the PnP refinement
are taken by batched products, so the pose agrees to rounding, not bit for
bit.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import LandmarkState
from ..frontend.features import Features, extract_features
from ..geometry import cameras as cam_models
from ..geometry import lie
from ..ops import hamming
from ..ops.compact import compact_indices, take_rows
from ..solvers import pnp


@dataclasses.dataclass
class TrackResult:
    feats: Features
    match_lm: torch.Tensor       # [N] int64 global landmark slot or -1
    inlier: torch.Tensor         # [N] bool (subset of matches)
    had_candidate: torch.Tensor  # [N] bool: a gated landmark candidate
    #                              existed (even if the ratio test failed)
    T_w_c: torch.Tensor          # [7] estimated pose (RANSAC+GN result)
    num_matches: torch.Tensor    # [] int64
    num_inliers: torch.Tensor    # [] int64
    motion_err: torch.Tensor     # [] float32 (gate statistic)
    pnp_ok: torch.Tensor         # [] bool (enough matches & inliers)


def project_landmarks(lm: LandmarkState, T_w_c, cam_name, intr, width,
                      height, z_threshold):
    """Project all landmarks; mask behind/out-of-image ones. T_w_c [7]
    against lm.pos [L, 3], or [S, 7] against [S, L, 3]."""
    p_c = lie.se3_apply(lie.se3_inv(T_w_c).unsqueeze(-2), lm.pos)
    proj = cam_models.project(cam_name, intr, p_c)
    ok = (lm.valid
          & (p_c[..., 2] >= z_threshold)
          & (proj[..., 0] >= 0) & (proj[..., 0] <= width)
          & (proj[..., 1] >= 0) & (proj[..., 1] <= height))
    return proj, ok


def track_frame(img_l, lm: LandmarkState, predicted_pose, gate_pose, vel,
                intr0, cam_name: str = "ds", num_features: int = 1500,
                inview_cap: int = 2048, width: int = 752, height: int = 480,
                z_threshold=0.1, match_max_dist_2d=20.0, match_threshold=70,
                match_ratio=1.2, pnp_threshold=0.000018,
                num_hypotheses: int = 256, min_matches=10,
                quality_level=0.01, min_distance: int = 8,
                rotate_features: bool = True, num_octaves: int = 1,
                generator: torch.Generator = None,
                feats: Features = None, sample_idx=None) -> TrackResult:
    """Track one left image against the map; ``generator`` drives the
    RANSAC draws, or ``sample_idx`` [H, 6] gives them. ``feats`` overrides
    the built-in extraction with pre-computed Features of the left image (a
    learned frontend's hook). With a leading sequence axis on the image,
    the landmark state, the poses and the velocity (and on ``sample_idx``)
    S sequences are tracked at once (module docstring) and every field of
    the result leads with S."""
    if feats is None:
        feats = extract_features(img_l, num_features=num_features,
                                 quality_level=quality_level,
                                 min_distance=min_distance,
                                 rotate_features=rotate_features,
                                 num_octaves=num_octaves)

    # ---- project + compact in-view landmarks (newest-first) ----
    proj, in_view = project_landmarks(lm, predicted_pose, cam_name, intr0,
                                      width, height, z_threshold)
    sel, sel_valid = compact_indices(in_view, inview_cap, newest_first=True)
    sel = torch.clamp(sel, 0, lm.pos.shape[-2] - 1)
    sel_valid = sel_valid & take_rows(in_view, sel)

    # ---- guided landmark matching ----
    match_local, m_ok, had_cand = hamming.match_landmarks(
        feats.bits, feats.valid, take_rows(lm.bank_bits, sel),
        take_rows(lm.bank_valid, sel), feats.corners, take_rows(proj, sel),
        sel_valid, max_dist_2d=match_max_dist_2d,
        threshold=match_threshold, ratio=match_ratio)
    local = torch.clamp(match_local, min=0)
    match_lm = torch.where(m_ok, take_rows(sel, local),
                           torch.full_like(local, -1))
    num_matches = m_ok.sum(dim=-1)

    # ---- PnP localization ----
    bearings = cam_models.unproject(cam_name, intr0, feats.corners)
    points = take_rows(take_rows(lm.pos, sel), local)
    T_ransac, inlier, num_inl, pnp_valid = pnp.ransac_pnp(
        points, bearings, m_ok, pnp_threshold,
        num_hypotheses=num_hypotheses, generator=generator,
        sample_idx=sample_idx)
    enough = (num_matches >= min_matches) & pnp_valid
    T_w_c = torch.where(enough[..., None], T_ransac, predicted_pose)
    inlier = inlier & enough[..., None] & m_ok

    return TrackResult(
        feats=feats, match_lm=match_lm, inlier=inlier,
        had_candidate=had_cand, T_w_c=T_w_c, num_matches=num_matches,
        num_inliers=torch.where(enough, num_inl, torch.zeros_like(num_inl)),
        motion_err=_motion_err(gate_pose, T_w_c, vel), pnp_ok=enough)


def _motion_err(gate_pose, T_w_c, vel):
    """The motion-model gate statistic (tracking.h:131-133); a non-finite
    pose must read as a FAILED gate, so it gives inf."""
    se3_vel = lie.se3_log(lie.se3_mul(lie.se3_inv(gate_pose), T_w_c))
    err = torch.sum(torch.abs(se3_vel[..., :3] - lie.se3_log(vel)[..., :3]),
                    dim=-1)
    return torch.where(torch.isfinite(err), err,
                       torch.full_like(err, float("inf")))


def retry_localize(res: TrackResult, lm: LandmarkState, predicted_pose,
                   gate_pose, vel, intr0, cam_name: str = "ds",
                   pnp_threshold=0.000018, num_hypotheses: int = 256,
                   min_matches=10, generator: torch.Generator = None,
                   sample_idx=None) -> TrackResult:
    """Redraw the RANSAC localization on an existing match set: the
    reference's track_camera retry loop (tracking.h:90-160) re-runs only the
    randomized solver when the motion gate rejects the pose. ``sample_idx``
    [H, 6] overrides the draws from ``generator``."""
    bearings = cam_models.unproject(cam_name, intr0, res.feats.corners)
    m_ok = res.match_lm >= 0
    points = lm.pos[torch.clamp(res.match_lm, min=0)]
    T_ransac, inlier, num_inl, pnp_valid = pnp.ransac_pnp(
        points, bearings, m_ok, pnp_threshold,
        num_hypotheses=num_hypotheses, generator=generator,
        sample_idx=sample_idx)
    enough = (res.num_matches >= min_matches) & pnp_valid
    T_w_c = torch.where(enough, T_ransac, predicted_pose)
    return dataclasses.replace(
        res, T_w_c=T_w_c, inlier=inlier & enough & m_ok,
        num_inliers=torch.where(enough, num_inl, torch.zeros_like(num_inl)),
        motion_err=_motion_err(gate_pose, T_w_c, vel), pnp_ok=enough)
