"""Trajectory evaluation: SE3 Umeyama alignment + ATE RMSE.

Same semantics as the reference's ``alignSVD``
(the reference's src/slam.cpp:1618-1710): associate each estimated keyframe
timestamp to linearly-interpolated ground truth (skipping GT gaps > 110 ms),
align with the SVD/Umeyama rotation (no scale — stereo fixes scale), and
report RMSE of the residuals.

Host copy of ``vslam_tpu/eval/ate.py`` for the PyTorch port.
"""

from __future__ import annotations

import numpy as np


def associate(est_t_ns, est_pos, gt_t_ns, gt_pos, max_gap_ns: float = 1.1e8):
    """Interpolate GT at estimate timestamps (slam.cpp:1630-1655)."""
    est_t_ns = np.asarray(est_t_ns)
    gt_t_ns = np.asarray(gt_t_ns)
    est_assoc, gt_assoc = [], []
    for i, t in enumerate(est_t_ns):
        j = np.searchsorted(gt_t_ns, t, side="right") - 1
        if j < 0 or j >= len(gt_t_ns) - 1:
            continue
        gap = gt_t_ns[j + 1] - gt_t_ns[j]
        if gap > max_gap_ns:
            continue
        ratio = (t - gt_t_ns[j]) / gap
        gt_assoc.append((1.0 - ratio) * gt_pos[j] + ratio * gt_pos[j + 1])
        est_assoc.append(est_pos[i])
    return np.asarray(est_assoc), np.asarray(gt_assoc)


def align_svd(est, gt):
    """SE3 Umeyama alignment (rotation + translation, no scale).

    Returns (R, t, ate_rmse) with gt ~= R @ est + t.
    """
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    mean_est = est.mean(axis=0)
    mean_gt = gt.mean(axis=0)
    e = est - mean_est
    g = gt - mean_gt
    cov = g.T @ e
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mean_gt - R @ mean_est
    aligned = est @ R.T + t
    err = aligned - gt
    ate = float(np.sqrt(np.mean(np.sum(err * err, axis=1))))
    return R, t, ate


def ate_rmse(est_t_ns, est_pos, gt_t_ns, gt_pos) -> float:
    """End-to-end: associate + align + RMSE. NaN if too few associations."""
    est_a, gt_a = associate(est_t_ns, est_pos, gt_t_ns, gt_pos)
    if len(est_a) < 3:
        return float("nan")
    return align_svd(est_a, gt_a)[2]
