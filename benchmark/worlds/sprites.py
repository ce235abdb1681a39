"""World kind ``sprites``: textured billboards with a planted corner at 3D
points, a frozen copy of the port's ``vslam_tpu_torch/synthetic.py``
``generate``, rendered on the device.

The numpy world builder draws the same random numbers in the same order
as the port's; the painter's loop (far first, near overwrites) becomes one
``scatter_reduce`` per batch of frames: each pixel keeps the nearest
billboard that covers it.

A traffic file's ``world`` entry: ``box`` ((x0, x1), (y0, y1), (z0, z1))
in metres, ``box_follows_path`` (the box's far z grows to the path's end
plus its depth of view), ``points_per_m3``, and ``layout_seed``, which
fixes where the billboards stand and which textures exist; the run's seed
then deals the textures to the billboards, so every seed does the same
work in another arrangement.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import geometry

PATCH_RADIUS = 7          # billboards are 15 x 15 pixels
BACKGROUND = 100          # grey of the empty sky


def sprite_world(rng, num_points: int, box):
    """(points [P, 3] float64, patches [P, 15, 15] uint8): points uniform
    in ``box`` ((x0, x1), (y0, y1), (z0, z1)), each with a band-limited
    random texture, a ramp that fixes its orientation and a checkerboard
    corner at its center; the draws of ``synthetic.generate``."""
    (x0, x1), (y0, y1), (z0, z1) = box
    points = np.stack([rng.uniform(x0, x1, num_points),
                       rng.uniform(y0, y1, num_points),
                       rng.uniform(z0, z1, num_points)], axis=-1)
    PR = PATCH_RADIUS
    patches = rng.randint(60, 195, (num_points, 2 * PR + 1, 2 * PR + 1)
                          ).astype(np.float64)
    theta = rng.uniform(0, 2 * np.pi, num_points)
    gy, gx = np.mgrid[-PR:PR + 1, -PR:PR + 1]
    patches = patches + (np.cos(theta)[:, None, None] * gx
                         + np.sin(theta)[:, None, None] * gy) / PR * 55.0
    for _ in range(2):
        p = np.pad(patches, ((0, 0), (1, 1), (1, 1)), mode="edge")
        patches = (p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
                   + p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
                   + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]) / 9.0
    patches = np.clip(patches, 0, 255).astype(np.uint8)
    dark = rng.randint(0, 50, (num_points, 2))
    bright = rng.randint(205, 255, (num_points, 2))
    c = PR
    patches[:, c - 3:c, c - 3:c] = dark[:, 0, None, None]
    patches[:, c + 1:c + 4, c + 1:c + 4] = dark[:, 1, None, None]
    patches[:, c - 3:c, c + 1:c + 4] = bright[:, 0, None, None]
    patches[:, c + 1:c + 4, c - 3:c] = bright[:, 1, None, None]
    return points, patches


def render_sprites(points, patches, cam_poses, intr, width, height, device,
                   batch: int = 128):
    """uint8 [F, H, W] host images of the billboards seen from the camera
    poses ``cam_poses`` [F, 7] (T_w_c): each pixel shows the nearest
    billboard whose 15 x 15 footprint covers it (the port's far-to-near
    painter), the background elsewhere."""
    PR = PATCH_RADIUS
    dev = torch.device(device)
    pts = torch.as_tensor(points, dtype=torch.float64, device=dev)
    pat = torch.as_tensor(patches.reshape(len(patches), -1), device=dev)
    fx, fy, cx, cy = (float(v) for v in intr[:4])
    T_c_w = geometry.se3_inv(np.asarray(cam_poses, np.float64))
    dy, dx = torch.meshgrid(torch.arange(-PR, PR + 1, device=dev),
                            torch.arange(-PR, PR + 1, device=dev),
                            indexing="ij")
    foot = (dy * width + dx).reshape(-1)                 # [225]
    out = np.empty((len(cam_poses), height, width), np.uint8)
    dst = torch.from_numpy(out)
    big = torch.iinfo(torch.int64).max
    for b0 in range(0, len(cam_poses), batch):
        T = torch.as_tensor(T_c_w[b0:b0 + batch], device=dev)
        B = T.shape[0]
        q = T[:, None, 3:7]
        qv, qw = q[..., :3], q[..., 3:4]
        v = pts[None].expand(B, -1, -1)
        uv_ = torch.linalg.cross(qv.expand_as(v), v, dim=-1)
        uuv = torch.linalg.cross(qv.expand_as(v), uv_, dim=-1)
        pc = v + 2.0 * (qw * uv_ + uuv) + T[:, None, :3]   # [B, P, 3]
        z = torch.clamp(pc[..., 2], min=1e-6)
        x = torch.round(fx * pc[..., 0] / z + cx).to(torch.int64)
        y = torch.round(fy * pc[..., 1] / z + cy).to(torch.int64)
        keep = ((pc[..., 2] >= 0.5) & (x >= PR + 1) & (y >= PR + 1)
                & (x < width - PR - 1) & (y < height - PR - 1))
        # rank 0 = nearest: the painter's last write
        order = torch.argsort(pc[..., 2], dim=1)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(order.shape[1], device=dev)
                      .expand(B, -1).contiguous())
        bi, pi = torch.nonzero(keep, as_tuple=True)
        center = (bi * height + y[bi, pi]) * width + x[bi, pi]
        pix = (center[:, None] + foot[None]).reshape(-1)
        key = (rank[bi, pi][:, None] * foot.numel()
               + torch.arange(foot.numel(), device=dev)[None]).reshape(-1)
        win = torch.full((B * height * width,), big, dtype=torch.int64,
                         device=dev)
        win.scatter_reduce_(0, pix, key, reduce="amin")
        hit = win != big
        img = torch.full((B * height * width,), BACKGROUND,
                         dtype=torch.uint8, device=dev)
        r, off = win[hit] // foot.numel(), win[hit] % foot.numel()
        bframe = torch.nonzero(hit, as_tuple=True)[0] // (height * width)
        img[hit] = pat[order[bframe, r], off]
        dst[b0:b0 + B].copy_(img.reshape(B, height, width))
    return out


def render(spec: dict, rig, poses, rng, device):
    """(left, right) uint8 [F, H, W] host images of the world ``spec``
    seen along ``poses`` [F, 7], the textures dealt by ``rng``."""
    layout = (np.random.RandomState(spec["layout_seed"])
              if "layout_seed" in spec else rng)
    box = spec["box"]
    if spec.get("box_follows_path"):
        z_end = poses[-1, 2] + box[2][1]
        box = (box[0], box[1], (box[2][0], z_end))
    volume = np.prod([hi - lo for lo, hi in box])
    points, patches = sprite_world(layout, int(round(
        spec["points_per_m3"] * volume)), box)
    if layout is not rng:
        patches = patches[rng.permutation(len(patches))]
    right_poses = geometry.se3_compose(
        poses, np.broadcast_to(rig.T_0_1, poses.shape))
    return tuple(render_sprites(points, patches, p, intr, rig.width,
                                rig.height, device)
                 for p, intr in ((poses, rig.intrinsics[0]),
                                 (right_poses, rig.intrinsics[1])))
