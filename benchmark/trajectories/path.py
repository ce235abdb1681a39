"""Trajectory kind ``path``: a drift with sinusoidal sway and yaw.

position(f) = ``velocity`` * f + the sum of amp * sin(2 pi f / period) on
each ``[axis, amp, period]`` of ``sway``; yaw(f) the same sum over each
``[amp, period]`` of ``yaw``; the camera looks along +z, turned by the
yaw. Frame 0 is the identity pose.
"""

import numpy as np

from harness import geometry


def poses(spec: dict, num_frames: int) -> np.ndarray:
    """[F, 7] left-camera poses T_w_c of frames 0..F-1."""
    f = np.arange(num_frames, dtype=np.float64)
    pos = np.asarray(spec.get("velocity", [0, 0, 0]), np.float64)[None] \
        * f[:, None]
    for axis, amp, period in spec.get("sway", []):
        pos[:, axis] += amp * np.sin(2 * np.pi * f / period)
    yaw = np.zeros_like(f)
    for amp, period in spec.get("yaw", []):
        yaw += amp * np.sin(2 * np.pi * f / period)
    return np.concatenate([pos, geometry.yaw_quat(yaw)], -1)
