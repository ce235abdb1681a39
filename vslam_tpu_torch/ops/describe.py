"""Orientation (intensity centroid) + rotated-BRIEF descriptors.

Port of ``vslam_tpu/ops/describe.py``, gather path: one (2*R+1)^2 patch
per corner (R=19 covers every rotated tap), the moment sums as masked
reductions, and all 256 tests as one batched gather. The reference's
one-hot matmul sampling (its ``use_mxu`` branches) is a TPU layout choice
with the same results and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .pattern import HALF_PATCH_SIZE, PATTERN_A, PATTERN_B

PATCH_RADIUS = 19
_PATCH_W = 2 * PATCH_RADIUS + 1  # 39

# disc mask and coordinate grids for the orientation moments ([-15, 15]^2)
_oy, _ox = np.mgrid[-HALF_PATCH_SIZE:HALF_PATCH_SIZE + 1,
                    -HALF_PATCH_SIZE:HALF_PATCH_SIZE + 1]
_DISC = (_ox * _ox + _oy * _oy) <= HALF_PATCH_SIZE * HALF_PATCH_SIZE
_DISC_WX = (_DISC * _ox).astype(np.float32)
_DISC_WY = (_DISC * _oy).astype(np.float32)


def gather_patches(img, corners, radius: int = PATCH_RADIUS):
    """img [H, W], corners [K, 2] float (x, y) -> [K, 2r+1, 2r+1] float32.

    Out-of-range corners (e.g. the (-1,-1) invalid fill) are clamped, so
    every read stays inside the image; callers rely on the validity mask.
    """
    h, w = img.shape
    cx = torch.clamp(corners[:, 0].to(torch.int64), radius, w - radius - 1)
    cy = torch.clamp(corners[:, 1].to(torch.int64), radius, h - radius - 1)
    off = torch.arange(-radius, radius + 1, device=img.device)
    rows = (cy[:, None] + off)[:, :, None]          # [K, k, 1]
    cols = (cx[:, None] + off)[:, None, :]          # [K, 1, k]
    return img[rows, cols].to(torch.float32)


def compute_angles(patches, rotate_features: bool = True):
    """Intensity-centroid orientation per patch. patches [K, 39, 39] f32."""
    if not rotate_features:
        return patches.new_zeros(patches.shape[0])
    c = PATCH_RADIUS
    sub = patches[:, c - HALF_PATCH_SIZE:c + HALF_PATCH_SIZE + 1,
                  c - HALF_PATCH_SIZE:c + HALF_PATCH_SIZE + 1]
    # integer pixels times integer weights: every sum below is an exact
    # f32 integer whatever the summation order
    m01 = torch.sum(sub * patches.new_tensor(_DISC_WY), dim=(1, 2))
    m10 = torch.sum(sub * patches.new_tensor(_DISC_WX), dim=(1, 2))
    return torch.atan2(m01, m10)


def compute_descriptors(patches, angles):
    """Rotated BRIEF bits. patches [K, 39, 39], angles [K] -> bits [K, 256]
    uint8."""
    ca = torch.cos(angles)[:, None]  # [K, 1]
    sa = torch.sin(angles)[:, None]

    def rotated_idx(pat):
        # pat [256, 2] -> flattened patch indices [K, 256]; torch.round
        # rounds half to even, as jnp.round does
        pat = torch.as_tensor(pat, dtype=torch.float32, device=angles.device)
        px, py = pat[:, 0][None, :], pat[:, 1][None, :]
        rx = torch.round(ca * px - sa * py).to(torch.int64) + PATCH_RADIUS
        ry = torch.round(sa * px + ca * py).to(torch.int64) + PATCH_RADIUS
        rx = torch.clamp(rx, 0, _PATCH_W - 1)
        ry = torch.clamp(ry, 0, _PATCH_W - 1)
        return ry * _PATCH_W + rx

    flat = patches.reshape(patches.shape[0], -1)  # [K, 39*39]
    va = torch.gather(flat, 1, rotated_idx(PATTERN_A))
    vb = torch.gather(flat, 1, rotated_idx(PATTERN_B))
    return (va < vb).to(torch.uint8)


def describe(img, corners, rotate_features: bool = True):
    """img [H, W], corners [K, 2] -> (angles [K] f32, bits [K, 256] uint8)."""
    patches = gather_patches(img, corners)
    angles = compute_angles(patches, rotate_features)
    return angles, compute_descriptors(patches, angles)


_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_bits(bits):
    """[..., 256] {0,1} -> [..., 32] uint8, LSB-first within each byte."""
    b = bits.reshape(bits.shape[:-1] + (32, 8)).to(torch.int32)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    return torch.sum(b * w, dim=-1).to(torch.uint8)


def unpack_bits(packed):
    """[..., 32] uint8 -> [..., 256] {0,1} uint8."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (256,)).to(torch.uint8)
