"""Track-based SfM helpers (the reference's course/legacy path).

Port of ``vslam_tpu/pipeline/sfm.py``; equivalents of
include/visnav/map_utils.h:120-317:
- ``initialize_scene_from_stereo_pair``: map init from a known-extrinsic
  image pair by triangulating shared tracks;
- ``triangulate_tracks`` (add_new_landmarks_between_cams): triangulate
  tracks shared between two posed cameras into new landmarks;
- ``localize_camera_tracks``: PnP of a new camera against landmarks matched
  via tracks.

These operate on the track dictionaries from ``utils/tracks.py`` plus
dense corner arrays, and reuse the port's batched solvers (triangulation,
PnP) on the device of the intrinsics ``intr``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..geometry import cameras as cam_models
from ..geometry import lie
from ..geometry.triangulate import triangulate_midpoint
from ..solvers import pnp


def _pow2(n: int, lo: int = 16) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _on(x, like):
    """``x`` (numpy or tensor) as a float tensor on ``like``'s device."""
    if not torch.is_tensor(x):
        x = np.array(x)     # a copy: the caller's array may be read-only
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def triangulate_tracks(
    tracks: Dict[int, Dict[int, int]],
    img_i: int,
    img_j: int,
    corners_i,
    corners_j,
    T_w_i,
    T_w_j,
    intr,
    cam_name: str,
    existing: Dict[int, np.ndarray],
) -> Dict[int, np.ndarray]:
    """add_new_landmarks_between_cams: triangulate tracks seen in both
    images that are not yet landmarks. Returns {track_id: p_w}."""
    tids = [t for t, obs in tracks.items()
            if img_i in obs and img_j in obs and t not in existing]
    if not tids:
        return {}
    uv_i = np.asarray([np.asarray(corners_i)[tracks[t][img_i]] for t in tids])
    uv_j = np.asarray([np.asarray(corners_j)[tracks[t][img_j]] for t in tids])
    f_i = cam_models.unproject(cam_name, intr, _on(uv_i, intr))
    f_j = cam_models.unproject(cam_name, intr, _on(uv_j, intr))
    T_w_i, T_w_j = _on(T_w_i, intr), _on(T_w_j, intr)
    T_i_j = lie.se3_mul(lie.se3_inv(T_w_i), T_w_j)
    p_i, ok = triangulate_midpoint(f_i, f_j, T_i_j)
    p_w = lie.se3_apply(T_w_i, p_i)
    okn = ok.cpu().numpy()
    pwn = p_w.cpu().numpy()
    return {t: pwn[k] for k, t in enumerate(tids) if okn[k]}


def initialize_scene_from_stereo_pair(
    tracks: Dict[int, Dict[int, int]],
    img_i: int,
    img_j: int,
    corners_i,
    corners_j,
    T_i_j,
    intr,
    cam_name: str,
) -> Tuple[Dict[int, np.ndarray], torch.Tensor, torch.Tensor]:
    """Map init: camera i at identity, camera j at the calibrated extrinsic
    (map_utils.h initialize_scene_from_stereo_pair semantics)."""
    T_w_i = lie.identity_pose(intr.dtype, intr.device)
    T_w_j = _on(T_i_j, intr)
    landmarks = triangulate_tracks(
        tracks, img_i, img_j, corners_i, corners_j, T_w_i, T_w_j, intr,
        cam_name, existing={})
    return landmarks, T_w_i, T_w_j


def localize_camera_tracks(
    img_id: int,
    tracks: Dict[int, Dict[int, int]],
    corners,
    landmarks: Dict[int, np.ndarray],
    intr,
    cam_name: str,
    threshold: float,
    num_hypotheses: int = 256,
    generator: torch.Generator = None,
    sample_idx=None,
):
    """Track-based PnP (map_utils.h localize_camera over shared tracks).
    The RANSAC draws come from ``generator``, or ``sample_idx`` [H, 6]
    gives them (indices into the padded list of shared tracks).

    Returns (T_w_c [7], inlier_track_ids)."""
    shared = [t for t, obs in tracks.items()
              if img_id in obs and t in landmarks]
    if len(shared) < 4:
        return None, []
    cap = _pow2(len(shared))
    pts = np.zeros((cap, 3), np.float32)
    pts[:len(shared)] = np.stack([landmarks[t] for t in shared])
    uv = np.asarray([np.asarray(corners)[tracks[t][img_id]] for t in shared])
    brs = torch.zeros((cap, 3), dtype=intr.dtype, device=intr.device)
    brs[:len(shared)] = cam_models.unproject(cam_name, intr, _on(uv, intr))
    valid = torch.arange(cap, device=intr.device) < len(shared)
    T_wc, inl, num, ok = pnp.ransac_pnp(
        _on(pts, intr), brs, valid, threshold,
        num_hypotheses=num_hypotheses, generator=generator,
        sample_idx=sample_idx)
    if not bool(ok):
        return None, []
    inl = inl.cpu().numpy()[:len(shared)]
    return T_wc, [shared[i] for i in np.nonzero(inl)[0]]
