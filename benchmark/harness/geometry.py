"""Pose helpers (float64 numpy, the formulas of the port's
``synthetic.py``) and the stereo rig a configuration file states. Poses
are ``T_w_c`` of the left camera, ``[x y z qx qy qz qw]``."""

from __future__ import annotations

import dataclasses

import numpy as np


def quat_rotate(q, v):
    qv, qw = q[..., :3], q[..., 3:4]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def se3_inv(T):
    q = T[..., 3:7] * np.array([-1.0, -1, -1, 1])
    t = -quat_rotate(q, T[..., :3])
    return np.concatenate([t, q], -1)


def se3_compose(T1, T2):
    x1, y1, z1, w1 = (T1[..., i] for i in range(3, 7))
    x2, y2, z2, w2 = (T2[..., i] for i in range(3, 7))
    q = np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)
    t = T1[..., :3] + quat_rotate(T1[..., 3:7], T2[..., :3])
    return np.concatenate([t, q], -1)


def yaw_quat(theta):
    theta = np.asarray(theta, np.float64)
    z = np.zeros_like(theta)
    return np.stack([z, np.sin(theta / 2), z, np.cos(theta / 2)], -1)


# ---------------------------------------------------------------------------
# the rig of a configuration file (rectified pinhole stereo)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rig:
    width: int
    height: int
    intrinsics: np.ndarray   # [2, 8] fx fy cx cy + 4 zeros (pinhole)
    T_i_c: np.ndarray        # [2, 7] camera-to-body poses

    @property
    def T_0_1(self):
        return self.T_i_c[1]


def make_rig(width: int, height: int, fx: float, fy: float, cx: float,
             cy: float, baseline_m: float) -> Rig:
    """A rectified pair: both cameras ``fx fy cx cy``, the right one
    ``baseline_m`` along the left camera's +x."""
    row = [fx, fy, cx, cy, 0, 0, 0, 0]
    T_i_c = np.array([[0, 0, 0, 0, 0, 0, 1.0],
                      [baseline_m, 0, 0, 0, 0, 0, 1.0]])
    return Rig(width, height, np.array([row, row], np.float64), T_i_c)


def rig_of(config: dict) -> Rig:
    """The rig a configuration file states."""
    c = config
    return make_rig(c["width"], c["height"], c["fx"], c["fy"], c["cx"],
                    c["cy"], c["baseline_m"])
