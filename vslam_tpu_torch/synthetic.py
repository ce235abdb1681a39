"""Synthetic stereo sequences with exact ground truth.

The reference is only verifiable against EuRoC downloads it cannot ship
(data/download_dataset.sh); for hermetic end-to-end tests we render a
synthetic world instead: textured point landmarks splatted into stereo
images along a smooth trajectory, with the generating poses as ground
truth. This exercises the full pipeline (detection, description, stereo
matching, triangulation, PnP tracking, BA) and lets tests assert real ATE
numbers.

Host copy of ``vslam_tpu/synthetic.py`` for the PyTorch port (the JAX
package cannot be imported where JAX is absent). Pinhole worlds are
generated with numpy alone and are byte-identical to the original's; the
other camera models project through the port's ``geometry/cameras.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .io.calib import Calibration

# pure-numpy pose helpers (no jax dependency for data generation)


def _quat_rotate_np(q, v):
    qv, qw = q[..., :3], q[..., 3:4]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def _se3_apply_np(T, p):
    return _quat_rotate_np(T[..., 3:7], p) + T[..., :3]


def _se3_inv_np(T):
    q = T[3:7] * np.array([-1.0, -1, -1, 1])
    t = -_quat_rotate_np(q, T[:3])
    return np.concatenate([t, q])


def _yaw_quat(theta):
    return np.array([0.0, np.sin(theta / 2), 0.0, np.cos(theta / 2)])


def _look_at(pos, target):
    """T_w_c with camera +z toward target, +y roughly world +y (image down)."""
    z = target - pos
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    n = np.linalg.norm(x)
    if n < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    else:
        x = x / n
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    # rotation matrix -> quaternion (w-first math, stored xyzw)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s, s / 4])
    else:
        i = np.argmax(np.diag(R))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
    q = q / np.linalg.norm(q)
    return np.concatenate([pos, q])


@dataclasses.dataclass
class SyntheticSequence:
    images: List[Tuple[np.ndarray, np.ndarray]]  # [(left, right)] uint8
    poses: np.ndarray        # [F, 7] T_w_c of left cam (ground truth)
    timestamps: np.ndarray   # [F] int64 ns
    calib: Calibration
    points: np.ndarray       # [P, 3] world landmarks


def make_calib(width=320, height=240, cam_type="pinhole") -> Calibration:
    fx = fy = 220.0
    if cam_type == "ds":
        # EuRoC-like double-sphere distortion
        row = [fx, fy, width / 2, height / 2, -0.23, 0.57, 0, 0]
    elif cam_type == "kb4":
        row = [fx, fy, width / 2, height / 2, 0.007, -0.0014, -0.0003,
               -0.0005]
    elif cam_type == "eucm":
        row = [fx, fy, width / 2, height / 2, 0.51, 0.9, 0, 0]
    else:
        row = [fx, fy, width / 2, height / 2, 0, 0, 0, 0]
    intr = np.array([row, row])
    T_i_c = np.array([
        [0, 0, 0, 0, 0, 0, 1.0],
        [0.11, 0, 0, 0, 0, 0, 1.0],   # 11 cm stereo baseline (EuRoC-like)
    ])
    return Calibration(T_i_c=T_i_c, intrinsics=intr,
                       cam_types=[cam_type, cam_type],
                       width=width, height=height)


def _project_pinhole_np(intr, p):
    fx, fy, cx, cy = intr[:4]
    z = np.maximum(p[..., 2], 1e-6)
    return np.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)


def _project_np(cam_type, intr, p):
    if cam_type == "pinhole":
        return _project_pinhole_np(intr, p)
    import torch

    from .geometry import cameras as _cam

    return _cam.project(
        cam_type, torch.as_tensor(np.asarray(intr), dtype=torch.float32),
        torch.as_tensor(np.asarray(p), dtype=torch.float32)).numpy()


def generate(
    num_frames: int = 40,
    num_points: int = 600,
    width: int = 320,
    height: int = 240,
    motion: str = "arc",
    seed: int = 0,
    cam_type: str = "pinhole",
    speed: float = 1.0,
) -> SyntheticSequence:
    rng = np.random.RandomState(seed)
    calib = make_calib(width, height, cam_type)

    # landmarks: a corridor of points in front of the trajectory, or a
    # central cluster for the orbiting "loop" motion
    if motion == "loop":
        # ring of landmarks AROUND the orbit; the camera looks outward so
        # each frame sees a distinct arc segment — place recognition can
        # then discriminate revisits (a single central cluster would make
        # every frame look alike to BoW)
        phi = rng.uniform(0, 2 * np.pi, num_points)
        rad = rng.uniform(7.0, 10.0, num_points)
        points = np.stack([
            rad * np.sin(phi),
            rng.uniform(-2.2, 2.2, num_points),
            -rad * np.cos(phi),
        ], axis=-1)
    else:
        points = np.stack([
            rng.uniform(-6, 10, num_points),
            rng.uniform(-3, 3, num_points),
            rng.uniform(2.0, 14.0, num_points),
        ], axis=-1)
    # per-point texture patches, high contrast. Must be larger than the
    # BRIEF tap radius fraction so descriptors of the same landmark agree
    # across views (the constant background makes out-of-patch taps equal).
    PR = 7  # patch radius -> 15x15
    patches = rng.randint(60, 195, (num_points, 2 * PR + 1, 2 * PR + 1)).astype(
        np.float64)
    # superimpose a strong linear ramp along a per-landmark direction so the
    # intensity-centroid orientation (keypoints.h:171-184) is stable across
    # views (random textures alone have a near-zero, flip-prone moment).
    theta = rng.uniform(0, 2 * np.pi, num_points)
    gy, gx = np.mgrid[-PR:PR + 1, -PR:PR + 1]
    ramp = (np.cos(theta)[:, None, None] * gx +
            np.sin(theta)[:, None, None] * gy) / PR * 55.0
    patches = patches + ramp
    # band-limit the texture (3x3 box blur, twice) so a +/-1 px corner
    # localization difference between views flips few descriptor bits —
    # real images are band-limited; per-pixel white noise is not.
    for _ in range(2):
        p = np.pad(patches, ((0, 0), (1, 1), (1, 1)), mode="edge")
        patches = (
            p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:] +
            p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:] +
            p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]) / 9.0
    patches = np.clip(patches, 0, 255).astype(np.uint8)
    # plant a strong checkerboard corner at the exact center of every patch
    # so detection localizes the same pixel in both views; the random outer
    # texture keeps descriptors distinctive between landmarks.
    dark = rng.randint(0, 50, (num_points, 2))
    bright = rng.randint(205, 255, (num_points, 2))
    c = PR
    for i in range(num_points):
        # quadrants meet at the CENTER PIXEL (row/col c stays texture) so
        # the corner response peaks on-pixel identically in both views
        patches[i, c - 3:c, c - 3:c] = dark[i, 0]
        patches[i, c + 1:c + 4, c + 1:c + 4] = dark[i, 1]
        patches[i, c - 3:c, c + 1:c + 4] = bright[i, 0]
        patches[i, c + 1:c + 4, c - 3:c] = bright[i, 1]

    # trajectory: slow forward arc with gentle yaw; ``speed`` scales the
    # per-frame motion (speed > 1 churns the visible landmark set, giving a
    # realistic organic keyframe cadence for benchmarks)
    poses = np.zeros((num_frames, 7))
    for f in range(num_frames):
        s = speed * f / max(num_frames - 1, 1)
        # EuRoC-like speeds: a few cm per frame so guided matching's 20 px
        # gate holds (the reference relies on the same assumption)
        if motion == "loop":
            # full orbit, camera facing outward at the landmark ring,
            # returning to the start. needs >= ~90 frames: camera yaw per
            # frame is the orbit step and the 20 px guided-match gate
            # tolerates only a few degrees until the constant-velocity
            # model locks in.
            th = 2 * np.pi * s
            pos = np.array([3.0 * np.sin(th), 0.04 * np.sin(2 * th),
                            -3.0 * np.cos(th)])
            target = np.array([9.0 * np.sin(th), 0.0, -9.0 * np.cos(th)])
            poses[f] = _look_at(pos, target)
            continue
        if motion == "arc":
            t = np.array([0.8 * s, 0.15 * np.sin(2 * np.pi * s), 1.1 * s])
            yaw = 0.12 * np.sin(2 * np.pi * s)
        else:  # straight
            t = np.array([0.0, 0.0, 1.2 * s])
            yaw = 0.0
        poses[f] = np.concatenate([t, _yaw_quat(yaw)])

    T_0_1 = np.concatenate([calib.T_i_c[1][:3], calib.T_i_c[1][3:]])

    images = []
    for f in range(num_frames):
        T_w_c = poses[f]
        T_c_w = _se3_inv_np(T_w_c)
        frame_imgs = []
        for cam in range(2):
            if cam == 0:
                T = T_c_w
            else:
                T = np.asarray(
                    _se3_inv_np(np.asarray(
                        _compose_np(T_w_c, T_0_1))))
            pc = _se3_apply_np(T[None, :], points)
            uv = _project_np(cam_type, calib.intrinsics[cam], pc)
            img = np.full((height, width), 100, dtype=np.uint8)
            order = np.argsort(-pc[:, 2])  # far first, near overwrites
            for i in order:
                if pc[i, 2] < 0.5:
                    continue
                x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
                if (x < PR + 1 or y < PR + 1 or x >= width - PR - 1
                        or y >= height - PR - 1):
                    continue
                img[y - PR:y + PR + 1, x - PR:x + PR + 1] = patches[i]
            frame_imgs.append(img)
        images.append((frame_imgs[0], frame_imgs[1]))

    timestamps = (np.arange(num_frames) * 50_000_000).astype(np.int64)  # 20 fps
    return SyntheticSequence(images=images, poses=poses,
                             timestamps=timestamps, calib=calib,
                             points=points)


def _compose_np(T1, T2):
    q1, q2 = T1[3:7], T2[3:7]
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    q = np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])
    t = T1[:3] + _quat_rotate_np(q1, T2[:3])
    return np.concatenate([t, q])
