"""The benchmark's plain frontend: Shi-Tomasi corners + rotated BRIEF.

A frozen copy of the port's classical frontend at one octave
(``vslam_tpu_torch/ops/detect.py``, ``ops/describe.py``,
``frontend/features.py``): it trains the SLAM cells' vocabulary and is
the reference that the program's keyframe features are held against.
Plain PyTorch; imports nothing of the program.

``dtype`` is the precision of the arithmetic: float32 is the reference;
the correctness control computes the same in bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .pattern import EDGE_THRESHOLD, HALF_PATCH_SIZE, PATTERN_A, PATTERN_B

PATCH_RADIUS = 19
_PATCH_W = 2 * PATCH_RADIUS + 1
_oy, _ox = np.mgrid[-HALF_PATCH_SIZE:HALF_PATCH_SIZE + 1,
                    -HALF_PATCH_SIZE:HALF_PATCH_SIZE + 1]
_DISC = (_ox * _ox + _oy * _oy) <= HALF_PATCH_SIZE * HALF_PATCH_SIZE


@dataclasses.dataclass
class Features:
    corners: torch.Tensor  # [N, 2] float32 (x, y); (-1, -1) where invalid
    bits: torch.Tensor     # [N, 256] uint8 {0, 1}
    valid: torch.Tensor    # [N] bool


def _shift(a, dy: int, dx: int):
    h, w = a.shape[-2:]
    p = F.pad(a, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def shi_tomasi_response(img):
    col = _shift(img, -1, 0) + 2.0 * img + _shift(img, 1, 0)
    ix = _shift(col, 0, 1) - _shift(col, 0, -1)
    row = _shift(img, 0, -1) + 2.0 * img + _shift(img, 0, 1)
    iy = _shift(row, 1, 0) - _shift(row, -1, 0)

    def box3(a):
        v = _shift(a, -1, 0) + a + _shift(a, 1, 0)
        return _shift(v, 0, -1) + v + _shift(v, 0, 1)

    sxx = box3(ix * ix)
    syy = box3(iy * iy)
    sxy = box3(ix * iy)
    half_trace = 0.5 * (sxx + syy)
    d = 0.5 * (sxx - syy)
    return half_trace - torch.sqrt(d * d + sxy * sxy)


def detect_corners(img, num_features, quality_level, min_distance,
                   edge=EDGE_THRESHOLD):
    """Up to ``num_features`` corners of one image [H, W] (float), strongest
    first, lower index first among ties."""
    h, w = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = (xs >= edge) & (xs < w - edge) & (ys >= edge) & (ys < h - edge)
    resp = torch.where(inb, resp, float("-inf"))
    max_resp = torch.amax(resp)
    resp = torch.where(resp >= quality_level * max_resp, resp, float("-inf"))
    r_nms = max(min_distance // 2, 1)
    k = 2 * r_nms + 1
    pooled = F.max_pool2d(resp.reshape(1, 1, h, w), (k, 1), stride=1,
                          padding=(r_nms, 0))
    pooled = F.max_pool2d(pooled, (1, k), stride=1,
                          padding=(0, r_nms)).reshape(h, w)
    resp = torch.where(resp >= pooled, resp, float("-inf"))
    b = r_nms
    hb, wb = -(-h // b), -(-w // b)
    resp_p = torch.full((hb * b, wb * b), float("-inf"), dtype=resp.dtype,
                        device=dev)
    resp_p[:h, :w] = resp
    blocks = resp_p.reshape(hb, b, wb, b).transpose(1, 2).reshape(
        hb, wb, b * b)
    blk_val, blk_arg = torch.max(blocks, dim=-1)
    vals, idx = torch.sort(blk_val.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:num_features], idx[:num_features]
    off = blk_arg.reshape(-1)[idx]
    yy = ((idx // wb) * b + off // b).to(torch.float32)
    xx = ((idx % wb) * b + off % b).to(torch.float32)
    valid = torch.isfinite(vals)
    corners = torch.stack([xx, yy], dim=-1)
    corners = torch.where(valid[:, None], corners, torch.full_like(corners, -1))
    return corners, valid


def describe(img, corners, dtype):
    """(bits [N, 256] uint8) of the corners: intensity-centroid angle and
    the 256 rotated tests, in ``dtype``."""
    h, w = img.shape
    dev = img.device
    cx = torch.clamp(corners[:, 0].to(torch.int64), PATCH_RADIUS,
                     w - PATCH_RADIUS - 1)
    cy = torch.clamp(corners[:, 1].to(torch.int64), PATCH_RADIUS,
                     h - PATCH_RADIUS - 1)
    off = torch.arange(-PATCH_RADIUS, PATCH_RADIUS + 1, device=dev)
    patches = img[(cy[:, None] + off)[:, :, None],
                  (cx[:, None] + off)[:, None, :]].to(dtype)
    c = PATCH_RADIUS
    sub = patches[:, c - HALF_PATCH_SIZE:c + HALF_PATCH_SIZE + 1,
                  c - HALF_PATCH_SIZE:c + HALF_PATCH_SIZE + 1]
    wy = torch.as_tensor((_DISC * _oy).astype(np.float32), device=dev).to(dtype)
    wx = torch.as_tensor((_DISC * _ox).astype(np.float32), device=dev).to(dtype)
    angles = torch.atan2(torch.sum(sub * wy, dim=(-2, -1)),
                         torch.sum(sub * wx, dim=(-2, -1)))
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]

    def rotated(pattern):
        pat = torch.as_tensor(pattern, device=dev).to(dtype)
        px, py = pat[:, 0], pat[:, 1]
        rx = torch.round(ca * px - sa * py).to(torch.int64) + PATCH_RADIUS
        ry = torch.round(sa * px + ca * py).to(torch.int64) + PATCH_RADIUS
        rx = torch.clamp(rx, 0, _PATCH_W - 1)
        ry = torch.clamp(ry, 0, _PATCH_W - 1)
        return ry * _PATCH_W + rx

    flat = patches.reshape(patches.shape[0], -1)
    va = torch.gather(flat, -1, rotated(PATTERN_A))
    vb = torch.gather(flat, -1, rotated(PATTERN_B))
    return (va < vb).to(torch.uint8)


def extract(img, num_features: int, quality_level: float, min_distance: int,
            dtype=torch.float32) -> Features:
    """Corners and descriptors of one uint8 image [H, W] (a tensor on any
    device), the arithmetic in ``dtype``."""
    img_f = img.to(dtype)
    corners, valid = detect_corners(img_f, num_features, quality_level,
                                    min_distance)
    bits = describe(img_f, corners, dtype)
    bits = torch.where(valid[:, None], bits, torch.zeros_like(bits))
    return Features(corners, bits, valid)


def pack_bits(bits):
    """[..., 256] {0,1} -> [..., 32] uint8, least significant bit first."""
    b = bits.reshape(bits.shape[:-1] + (32, 8)).to(torch.int32)
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                     device=bits.device)
    return torch.sum(b * w, dim=-1).to(torch.uint8)
