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


# Descriptor sets for the Hamming top-2 (no counterpart in the JAX
# package): inputs where ties decide the result, shared by the parity
# tests, the card tests and chip_smoke.py.

DESCRIPTOR_TIE_CASES = ("dup_tiles", "equidistant", "complement", "all_same")


def descriptor_ties(case: str, seed: int = 7):
    """{0,1} descriptors (a [N, 256], b [M, 256] uint8) and validity
    (va [N], vb [M] bool), numpy, where the argmin's lowest-index rule and
    the multiset second-best decide rows.

    dup_tiles: exact duplicates of near-match B rows in other 128- and
    512-wide tiles. equidistant: several B rows at one distance from an A
    row. complement: every candidate at distance 256 from A rows 0-3 (so
    best == 256) and at one equal distance from the others. all_same:
    every B row identical.
    """
    rng = np.random.RandomState(seed)
    n, m = {"dup_tiles": (40, 1100), "equidistant": (40, 600),
            "complement": (24, 300), "all_same": (24, 700)}[case]
    a = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    b = rng.randint(0, 2, (m, 256)).astype(np.uint8)
    if case == "dup_tiles":
        src = rng.randint(0, n, 100)
        b[:100] = np.where(rng.rand(100, 256) < 0.05, 1 - a[src], a[src])
        for start in (130, 600, 1000):
            b[start:start + 100] = b[:100]
    elif case == "equidistant":
        for i in range(20):
            dist = rng.randint(0, 40)
            for j in rng.choice(m, 3, replace=False):
                b[j] = a[i]
                b[j, rng.choice(256, dist, replace=False)] ^= 1
    elif case == "complement":
        a[1:4] = a[0]
        b[:] = 1 - a[0]
    else:
        b[:] = a[5]
    return a, b, rng.rand(n) < 0.9, rng.rand(m) < 0.9


LANDMARK_TIE_CASES = ("far_copies", "slot_ties", "at_256", "all_gated")


def landmark_ties(case: str, seed: int = 11):
    """Inputs of the guided landmark top-2, numpy, where the argmin's
    lowest-index rule, the multiset second-best and the 256 rule decide
    rows: (kp_bits [N, 256] uint8, kp_valid [N], kp_xy [N, 2] float32,
    bank_bits [P, B, 256] uint8, bank_valid [P, B], lm_xy [P, 2] float32,
    lm_valid [P], max_dist_2d 20.0).

    Keypoints lie on a 100 px grid; landmarks that no case places lie
    between grid points, outside every gate. far_copies: identical banks
    on four gated landmarks per keypoint, 37, 700 and 2100 apart in index
    (other gate steps and another 2048-landmark chunk), some of them
    invalid. slot_ties: equal distances reached through different bank
    slots of different landmarks, the lower landmark index through the
    higher slot. at_256: gated landmarks whose banks are all invalid, or
    complements of the keypoint (distance 256): best 256 with a candidate.
    all_gated: every landmark inside the gate of keypoints 0-3, banks
    repeating with period 37.
    """
    rng = np.random.RandomState(seed)
    n, p = {"far_copies": (28, 2200), "slot_ties": (28, 700),
            "at_256": (28, 600), "all_gated": (28, 650)}[case]
    nb = 4
    g = np.arange(n)
    kxy = np.stack([40.0 + 100 * (g % 7), 40.0 + 100 * (g // 7)], 1)
    kxy += rng.rand(n, 2) * 5
    cell = rng.randint(0, n, p)  # between grid points: >= 60 px from any
    lxy = kxy[cell] + 50.0 + rng.uniform(-5, 5, (p, 2))
    kp = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    bank = rng.randint(0, 2, (p, nb, 256)).astype(np.uint8)
    bv = rng.rand(p, nb) < 0.8
    lv = rng.rand(p) < 0.95
    kv = rng.rand(n) < 0.9

    def near(i, j):  # landmark j well inside keypoint i's gate
        lxy[j] = kxy[i] + rng.uniform(-8, 8, 2)
        lv[j] = True

    def noisy(i, d):  # keypoint i's descriptor with d bits flipped
        out = kp[i].copy()
        out[rng.choice(256, d, replace=False)] ^= 1
        return out

    if case == "far_copies":
        for i in range(24):
            same = np.stack([noisy(i, 0 if i % 2 == 0 else 5)
                             for _ in range(nb)])
            for j in (i, i + 37, i + 700, i + 2100):
                near(i, j)
                bank[j] = same
                bv[j] = True
            if i % 3 == 0:
                lv[i] = False  # the first copy is not a landmark: i + 37
    elif case == "slot_ties":
        for i in range(n):
            d = rng.randint(0, 30)
            j1, j2, j3 = i, 300 + i, 600 + i
            for j in (j1, j2, j3):
                near(i, j)
                bv[j] = True
            bank[j1, 3] = noisy(i, d)
            bank[j1, 1] = noisy(i, d)  # a tie inside one bank as well
            bank[j2, 0] = noisy(i, d)
            bank[j3, 2] = noisy(i, d + 1)
            if i % 4 == 1:
                bv[j1, [1, 3]] = False  # then j2 alone is at d
    elif case == "at_256":
        for i in range(n):
            for j in (i, 200 + i, 400 + i):
                near(i, j)
                if i < n // 2:
                    bv[j] = False
                else:
                    bank[j] = 1 - kp[i]
                    bv[j] = True
    else:
        kxy[1:4] = kxy[0] + rng.uniform(-0.5, 0.5, (3, 2))
        kv[:4] = True
        lxy[:] = kxy[0] + rng.uniform(-8, 8, (p, 2))
        lv[:] = True
        for j in range(37):
            bank[j] = np.stack([noisy(rng.randint(4), rng.choice([0, 2, 5]))
                                for _ in range(nb)])
        bank[37:] = np.resize(bank[:37], (p - 37, nb, 256))
    return (kp, kv, kxy.astype(np.float32), bank, bv,
            lxy.astype(np.float32), lv, 20.0)


# ---------------------------------------------------------------------------
# Large-map solver problems (tests/test_ba_scale.py's orbit, in numpy) and
# datasets on disk
# ---------------------------------------------------------------------------

ORBIT_PINHOLE = np.array([400.0, 400.0, 376.0, 240.0, 0, 0, 0, 0], np.float32)


def _orbit(n_pairs, pts_per_kf, obs_per_pt, noise, perturb, seed):
    """Camera pairs around a large circle looking outward, landmarks on the
    outer wall, each seen by ``obs_per_pt // 2`` consecutive pairs (both
    cameras). Returns ground truth, perturbed estimates and observations as
    numpy arrays."""
    import torch

    from .geometry import lie

    rng = np.random.RandomState(seed)
    K = 2 * n_pairs
    R_orbit, R_wall = 50.0, 65.0

    th = 2 * np.pi * np.arange(n_pairs) / n_pairs
    pos = np.stack([R_orbit * np.sin(th), np.zeros(n_pairs),
                    -R_orbit * np.cos(th)], -1)
    # yaw so +z looks outward; right cams offset along the local tangent
    q = np.stack([np.zeros(n_pairs), np.sin(th / 2), np.zeros(n_pairs),
                  np.cos(th / 2)], -1)
    poses_l = np.concatenate([pos, q], -1).astype(np.float32)
    tang = np.stack([np.cos(th), np.zeros(n_pairs), np.sin(th)], -1)
    poses_r = poses_l.copy()
    poses_r[:, :3] += 0.2 * tang
    poses_gt = np.stack([poses_l, poses_r], 1).reshape(K, 7)

    L = n_pairs * pts_per_kf
    lth = np.repeat(th, pts_per_kf) + rng.uniform(-0.02, 0.02, L)
    ly = rng.uniform(-6, 6, L)
    points_gt = np.stack([R_wall * np.sin(lth), ly,
                          -R_wall * np.cos(lth)], -1).astype(np.float32)

    base_pair = np.repeat(np.arange(n_pairs), pts_per_kf)
    offs = np.arange(obs_per_pt // 2) - obs_per_pt // 4
    obs_pair = (base_pair[:, None] + offs[None, :]) % n_pairs   # [L, o/2]
    obs_cam = np.stack([2 * obs_pair, 2 * obs_pair + 1], -1).reshape(L, -1)
    obs_point = np.broadcast_to(np.arange(L)[:, None], obs_cam.shape)
    obs_cam = obs_cam.reshape(-1).astype(np.int32)
    obs_point = obs_point.reshape(-1).astype(np.int32)

    # project the ground truth through the pinhole model
    T = poses_gt[obs_cam].astype(np.float64)
    qi = T[:, 3:7] * np.array([-1.0, -1, -1, 1])
    pc = _quat_rotate_np(qi, points_gt[obs_point] - T[:, :3])
    uv = _project_pinhole_np(ORBIT_PINHOLE, pc).astype(np.float32)
    in_img = ((uv[:, 0] > -200) & (uv[:, 0] < 952)
              & (uv[:, 1] > -200) & (uv[:, 1] < 680) & (pc[:, 2] > 0.1))
    uv = uv + rng.normal(0, noise, uv.shape).astype(np.float32)

    dpose = rng.normal(0, perturb, (K, 6)).astype(np.float32)
    dpose[:2] = 0.0
    poses0 = lie.se3_retract(torch.as_tensor(poses_gt),
                             torch.as_tensor(dpose)).numpy()
    points0 = (points_gt
               + rng.normal(0, 2 * perturb, points_gt.shape)).astype(
        np.float32)
    return dict(poses_gt=poses_gt, points_gt=points_gt, poses0=poses0,
                points0=points0, obs_cam=obs_cam, obs_point=obs_point,
                obs_pair=obs_pair, uv=uv, in_img=in_img)


def make_big_problem(n_pairs=4096, pts_per_kf=16, obs_per_pt=16, noise=0.3,
                     perturb=0.02, seed=0):
    """The stretch-scale global BA problem: at the defaults 8192 cameras,
    65,536 landmarks and 1,048,576 observations. Returns (fields of a
    ``BAProblem`` as numpy arrays, poses_gt [K, 7], points_gt [L, 3])."""
    o = _orbit(n_pairs, pts_per_kf, obs_per_pt, noise, perturb, seed)
    K, L = 2 * n_pairs, n_pairs * pts_per_kf
    prob = dict(
        poses=o["poses0"], pose_fixed=np.arange(K) < 2,
        intr=np.tile(ORBIT_PINHOLE, (K, 1)), points=o["points0"],
        point_valid=np.ones(L, bool), obs_cam=o["obs_cam"],
        obs_point=o["obs_point"], obs_uv=o["uv"], obs_valid=o["in_img"])
    return prob, o["poses_gt"], o["points_gt"]


def make_orbit_state(n_pairs=160, pts_per_kf=8, obs_per_pt=8, noise=0.3,
                     perturb=0.02, seed=0, capacity_kf=None,
                     capacity_lm=None, M=24, M2=48):
    """The same orbit as a keyframe / landmark state, for the global BA
    above the blocked solver's limit: returns (kf fields, lm fields,
    poses_gt [n_pairs, 2, 7]) as numpy arrays under the state dataclasses'
    field names (perturbed poses and points, noisy corners, the lifetime
    observation tables filled, nothing in the BA window)."""
    o = _orbit(n_pairs, pts_per_kf, obs_per_pt, noise, perturb, seed)
    h = obs_per_pt // 2
    assert 2 * h <= M2
    K = capacity_kf or n_pairs
    L = n_pairs * pts_per_kf
    Lc = capacity_lm or L
    N = pts_per_kf * h                     # features per keyframe image

    poses0 = o["poses0"].reshape(n_pairs, 2, 7)
    ident = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
    pose_l = np.tile(ident, (K, 1))
    pose_r = np.tile(ident, (K, 1))
    pose_l[:n_pairs], pose_r[:n_pairs] = poses0[:, 0], poses0[:, 1]

    # feature index of landmark l in pair obs_pair[l, j]: its rank j times
    # pts_per_kf plus its index within its base pair
    lm_ids = np.arange(L)
    feat = (np.arange(h)[None, :] * pts_per_kf
            + (lm_ids % pts_per_kf)[:, None])              # [L, h]
    uv = o["uv"].reshape(L, h, 2, 2)
    ok = o["in_img"].reshape(L, h, 2)
    corners = np.full((K, 2, N, 2), -1.0, np.float32)
    kp_valid = np.zeros((K, 2, N), bool)
    map_points = np.full((K, N), -1, np.int32)
    pair = o["obs_pair"]
    for cam in (0, 1):
        corners[pair, cam, feat] = uv[:, :, cam]
        kp_valid[pair, cam, feat] = ok[:, :, cam]
    map_points[pair, feat] = lm_ids[:, None]

    all_kf = np.full((Lc, M2), -1, np.int32)
    all_cam = np.zeros((Lc, M2), np.int32)
    all_feat = np.zeros((Lc, M2), np.int32)
    all_kf[:L, :2 * h] = np.where(ok, pair[:, :, None], -1).reshape(L, 2 * h)
    all_cam[:L, :2 * h] = np.tile(np.arange(2), (L, h))
    all_feat[:L, :2 * h] = np.repeat(feat, 2, axis=1)

    pos = np.zeros((Lc, 3), np.float32)
    pos[:L] = o["points0"]
    from_kf = np.full(Lc, -1, np.int32)
    from_kf[:L] = lm_ids // pts_per_kf
    anchor = pose_l[np.clip(from_kf, 0, None)]
    qi = anchor[:, 3:7] * np.array([-1.0, -1, -1, 1], np.float32)
    pos_c = _quat_rotate_np(qi, pos - anchor[:, :3]).astype(np.float32)
    valid_kf = np.arange(K) < n_pairs
    valid_lm = np.arange(Lc) < L
    kf = dict(
        frame_id=np.where(valid_kf, np.arange(K), -1).astype(np.int32),
        pose_l=pose_l, pose_r=pose_r, valid=valid_kf,
        active=np.zeros(K, bool),
        parent=np.where(valid_kf, np.arange(K) - 1, -1).astype(np.int32),
        corners=corners, desc=np.zeros((K, 2, N, 32), np.uint8),
        kp_valid=kp_valid, map_points=map_points,
        next_slot=np.asarray(n_pairs, np.int32))
    lm = dict(
        pos=pos, pos_c=np.where(valid_lm[:, None], pos_c, 0).astype(
            np.float32),
        from_kf=from_kf, valid=valid_lm, active=np.zeros(Lc, bool),
        obs_kf=np.full((Lc, M), -1, np.int32),
        obs_cam=np.zeros((Lc, M), np.int32),
        obs_feat=np.zeros((Lc, M), np.int32),
        all_kf=all_kf, all_cam=all_cam, all_feat=all_feat,
        bank_bits=np.zeros((Lc, 4, 256), np.uint8),
        bank_valid=np.zeros((Lc, 4), bool),
        bank_next=np.zeros(Lc, np.int32),
        next_slot=np.asarray(L, np.int32))
    return kf, lm, o["poses_gt"].reshape(n_pairs, 2, 7)


def write_mav0(seq: SyntheticSequence, path: str):
    """Write a sequence as an EuRoC mav0-layout dataset of binary PGM
    images: ``cam0/data.csv``, ``cam{0,1}/data/<timestamp>.pgm`` and the
    ground truth in ``state_groundtruth_estimate0/data.csv`` (one row per
    frame, the left camera's pose). Returns the timestamps [F] int64."""
    import os

    from .io import euroc

    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(path, cam, "data"), exist_ok=True)
    os.makedirs(os.path.join(path, "state_groundtruth_estimate0"),
                exist_ok=True)
    ts = np.asarray(seq.timestamps, np.int64)
    with open(os.path.join(path, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t, (img_l, img_r) in zip(ts, seq.images):
            name = f"{t}.pgm"
            f.write(f"{t},{name}\n")
            euroc.save_pgm(os.path.join(path, "cam0", "data", name), img_l)
            euroc.save_pgm(os.path.join(path, "cam1", "data", name), img_r)
    with open(os.path.join(path, "state_groundtruth_estimate0",
                           "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for t, T in zip(ts, np.asarray(seq.poses, np.float64)):
            f.write(f"{t}," + ",".join(repr(float(v)) for v in (
                T[0], T[1], T[2], T[6], T[3], T[4], T[5])) + "\n")
    return ts


def make_ring_graph(n=8, drift=0.05):
    """A pose graph as tests/test_pose_graph.py's ``make_chain`` builds it:
    ground truth on a circle, odometry edges with accumulated drift, one
    exact loop edge from the last pose to the first. Returns (gt [n, 7],
    poses0 [n, 7], edge_i [n], edge_j [n], edge_meas [n, 6]) as numpy
    arrays (float32 / int32)."""
    import torch

    from .geometry import lie

    th = 2 * np.pi * torch.arange(n, dtype=torch.float64) / n
    zero = torch.zeros_like(th)
    gt = lie.se3_make(
        torch.stack([torch.cos(th) * 2, torch.sin(th) * 2, zero], -1),
        lie.so3_exp_quat(torch.stack([zero, zero, th], -1))).float()
    noise = lie.se3_exp(torch.full((6,), drift / n) * torch.tensor(
        [1.0, 1, 0, 0, 0, 1]))
    rel = lie.se3_mul(lie.se3_mul(lie.se3_inv(gt[:-1]), gt[1:]),
                      noise.expand(n - 1, 7))
    poses = [gt[0]]
    for i in range(n - 1):
        poses.append(lie.se3_mul(poses[-1], rel[i]))
    loop = lie.se3_mul(lie.se3_inv(gt[n - 1]), gt[0])
    meas = lie.se3_log(torch.cat([rel, loop[None]]))
    edge_i = np.arange(n, dtype=np.int32)
    edge_j = ((np.arange(n) + 1) % n).astype(np.int32)
    return (gt.numpy(), torch.stack(poses).numpy(), edge_i, edge_j,
            meas.numpy())
