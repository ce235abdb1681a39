"""Two-view triangulation from unit bearing vectors (midpoint method).

Port of ``vslam_tpu/geometry/triangulate.py``: given stereo bearings and
the extrinsic T_1_2, the closed-form 2x2 least-squares along the two rays
gives the 3D point in frame 1, batched over matches.
"""

from __future__ import annotations

import torch

from .lie import quat_rotate, se3_q, se3_t


def triangulate_midpoint(f1, f2, T_1_2):
    """f1 [..., 3] unit bearings in frame 1, f2 [..., 3] in frame 2, T_1_2
    [7] pose of frame 2 in frame 1. Returns points in frame 1 [..., 3] and
    a validity flag (positive depths, non-parallel rays) [...]."""
    r2 = quat_rotate(se3_q(T_1_2), f2)  # f2 rotated into frame 1
    t = se3_t(T_1_2).expand(f1.shape)

    # min || a*f1 - (t + b*r2) ||^2 over (a, b)
    f1f1 = torch.sum(f1 * f1, dim=-1)
    r2r2 = torch.sum(r2 * r2, dim=-1)
    f1r2 = torch.sum(f1 * r2, dim=-1)
    f1t = torch.sum(f1 * t, dim=-1)
    r2t = torch.sum(r2 * t, dim=-1)

    det = f1f1 * r2r2 - f1r2 * f1r2
    det_safe = torch.where(torch.abs(det) < 1e-12,
                           torch.full_like(det, 1e-12), det)
    a = (r2r2 * f1t - f1r2 * r2t) / det_safe
    b = (f1r2 * f1t - f1f1 * r2t) / det_safe

    p1 = a[..., None] * f1
    p2 = t + b[..., None] * r2
    point = 0.5 * (p1 + p2)

    valid = (a > 0) & (b > 0) & (torch.abs(det) > 1e-12)
    return point, valid
