"""Cylindrical-panorama synthetic world: real perspective image warps.

The sprite renderer in synthetic.py draws viewpoint-invariant billboards,
which is enough for VO but too appearance-ambiguous for place recognition.
Here the world is a textured cylinder around the trajectory; every frame is
a true perspective resampling of the same texture, so descriptors behave
like real imagery (viewpoint-dependent overlap, genuine revisit similarity)
and organic BoW loop detection has something to detect.

Geometry is exact: ray-cylinder intersection per pixel, bilinear texture
sampling; ground truth = the generating poses. Texture is band-limited
noise (real images are band-limited).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .synthetic import SyntheticSequence, _compose_np, _look_at, make_calib


def _make_texture(rng, th=768, tw=3072,
                  octaves=((96, 384, 30.0), (192, 768, 25.0),
                           (384, 1536, 20.0)),
                  num_marks=500):
    """Structured random texture [th, tw] uint8, horizontally periodic.

    Band-limited noise octaves (each upsampled from a coarse grid and
    box-smoothed; rolls wrap, preserving horizontal periodicity for the
    cylinder seam) plus scattered high-contrast rectangles: pure noise has
    no stable corner structure, so BRIEF descriptors decorrelate within a
    few degrees of viewpoint change — the rectangles play the role of
    posters/fixtures on a real wall and anchor repeatable features.
    """
    tex = np.full((th, tw), 120.0)
    for cy, cx, amp in octaves:
        small = rng.uniform(-amp, amp, (cy, cx))
        big = np.kron(small, np.ones((th // cy, tw // cx)))
        for _ in range(2):
            big = (np.roll(big, 1, 0) + np.roll(big, -1, 0) + big
                   + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5.0
        tex += big
    for _ in range(num_marks):
        h = rng.randint(10, 48)
        w = rng.randint(10, 48)
        y = rng.randint(0, th - h)
        x = rng.randint(0, tw)  # may wrap the seam
        val = rng.uniform(10, 245)
        cols = (x + np.arange(w)) % tw
        tex[y:y + h, cols] = 0.25 * tex[y:y + h, cols] + 0.75 * val
    # light smoothing so marks are band-limited too (no aliasing under
    # perspective resampling)
    for _ in range(2):
        tex = (np.roll(tex, 1, 0) + np.roll(tex, -1, 0) + tex
               + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)) / 5.0
    return np.clip(tex, 0, 255).astype(np.uint8)


def _render_view(T_w_c, intr, tex, radius, half_height, width, height):
    """Perspective view of the textured cylinder from pose T_w_c."""
    fx, fy, cx, cy = intr[:4]
    th, tw = tex.shape
    xs = (np.arange(width) - cx) / fx
    ys = (np.arange(height) - cy) / fy
    mx, my = np.meshgrid(xs, ys)
    d_cam = np.stack([mx, my, np.ones_like(mx)], -1)  # pinhole rays

    # rotate to world
    q = T_w_c[3:7]
    qv, qw = q[:3], q[3]

    def rot(v):
        uv = np.cross(qv, v)
        uuv = np.cross(qv, uv)
        return v + 2.0 * (qw * uv + uuv)

    d = rot(d_cam.reshape(-1, 3))
    o = T_w_c[:3]

    # |o_xz + s d_xz|^2 = r^2; positive root
    a = d[:, 0] ** 2 + d[:, 2] ** 2
    b = 2 * (o[0] * d[:, 0] + o[2] * d[:, 2])
    c = o[0] ** 2 + o[2] ** 2 - radius * radius
    disc = np.maximum(b * b - 4 * a * c, 0.0)
    s = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-12)
    p = o[None, :] + s[:, None] * d

    u = (np.arctan2(p[:, 0], -p[:, 2]) / (2 * np.pi) + 0.5) * tw
    v = (p[:, 1] / (2 * half_height) + 0.5) * (th - 1)
    v = np.clip(v, 0, th - 1.001)
    u = u % tw

    u0 = u.astype(int)
    v0 = v.astype(int)
    du = u - u0
    dv = v - v0
    u1 = (u0 + 1) % tw
    v1 = np.minimum(v0 + 1, th - 1)
    val = (tex[v0, u0] * (1 - du) * (1 - dv) + tex[v0, u1] * du * (1 - dv)
           + tex[v1, u0] * (1 - du) * dv + tex[v1, u1] * du * dv)
    return val.reshape(height, width).astype(np.uint8)


def generate_pano_loop(
    num_frames: int = 96,
    width: int = 320,
    height: int = 240,
    orbit_radius: float = 3.0,
    cyl_radius: float = 6.0,
    revolutions: float = 1.25,
    baseline: float = 0.3,
    seed: int = 0,
) -> SyntheticSequence:
    """Orbit inside a textured cylinder, camera facing outward.

    ``revolutions > 1`` re-traverses the start of the loop, giving the
    place-recognition stack a sustained revisit window (a loop candidate
    must persist across >= num_consistency consecutive keyframes, so a
    single tangential revisit is too brief to ever fire). The default
    wall distance (cyl - orbit = 3m) keeps stereo disparity ~8px at the
    11cm synthetic baseline — far texture starves triangulation.

    Velocity eases in over the first ~10% of frames: the constant-velocity
    tracker has no motion prior at frame 1, so the guided-match gate can
    only bootstrap if early inter-frame motion is small (EuRoC sequences
    likewise start near-stationary).
    """
    rng = np.random.RandomState(seed)
    calib = make_calib(width, height, "pinhole")
    # widen the stereo rig: depth error scales as z^2/(fx*b); at the 11cm
    # EuRoC-like default the 3m wall only gets ~8px disparity and the
    # resulting ~6% depth noise dominates VO drift
    T_i_c = np.array(calib.T_i_c)
    T_i_c[1, 0] = baseline
    calib = dataclasses.replace(calib, T_i_c=T_i_c)
    tex = _make_texture(rng)
    T01 = np.concatenate([calib.T_i_c[1][:3], calib.T_i_c[1][3:]])

    warm = 0.1  # fraction of the path with linearly ramping speed
    poses = []
    images = []
    for f in range(num_frames):
        s = f / max(num_frames - 1, 1)
        u = (s * s / (2 * warm) if s < warm else s - warm / 2) / (1 - warm / 2)
        th_ang = 2 * np.pi * revolutions * u
        pos = np.array([orbit_radius * np.sin(th_ang),
                        0.03 * np.sin(2 * th_ang),
                        -orbit_radius * np.cos(th_ang)])
        target = pos * np.array([cyl_radius / orbit_radius, 1.0,
                                 cyl_radius / orbit_radius])
        T_w_l = _look_at(pos, target)
        poses.append(T_w_l)
        T_w_r = _compose_np(T_w_l, T01)
        img_l = _render_view(T_w_l, calib.intrinsics[0], tex, cyl_radius,
                             6.0, width, height)
        img_r = _render_view(T_w_r, calib.intrinsics[1], tex, cyl_radius,
                             6.0, width, height)
        images.append((img_l, img_r))

    return SyntheticSequence(
        images=images, poses=np.stack(poses),
        timestamps=(np.arange(num_frames) * 50_000_000).astype(np.int64),
        calib=calib, points=np.zeros((0, 3)),
    )
