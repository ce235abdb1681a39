"""Fused feature extraction: detection + orientation + description.

Port of ``vslam_tpu/frontend/features.py``: fixed output shapes
(num_features slots + validity mask) and the optional power-of-two
pyramid (``num_octaves > 1``): per-level budgets split geometrically,
corners reported in level-0 pixel coordinates, descriptors computed at
the detection scale.

``extract_features`` takes one image [H, W] or a stack [..., H, W] (the
multi-sequence path's [S, H, W]); the fields of ``Features`` then carry
the same leading axes, and every image is processed on its own (its own
quality threshold and top-k).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import describe as describe_ops
from ..ops import detect as detect_ops


@dataclasses.dataclass
class Features:
    corners: torch.Tensor  # [N, 2] float32 (x, y); (-1,-1) where invalid
    angles: torch.Tensor   # [N] float32
    bits: torch.Tensor     # [N, 256] uint8 descriptor bits
    valid: torch.Tensor    # [N] bool
    octave: Optional[torch.Tensor] = None  # [N] int32 pyramid level


def _downsample2(img_f):
    """2x2 mean-pool halving, rounded to integers (the pyramid step)."""
    h2, w2 = img_f.shape[-2] // 2, img_f.shape[-1] // 2
    return torch.round(
        img_f[..., :h2 * 2, :w2 * 2].reshape(
            img_f.shape[:-2] + (h2, 2, w2, 2)).mean(dim=(-3, -1)))


def _level_budgets(num_features: int, num_octaves: int):
    """Split the feature budget geometrically across levels."""
    raw = [2.0 ** (-o) for o in range(num_octaves)]
    total = sum(raw)
    n = [max(int(num_features * r / total), 8) for r in raw]
    n[0] += num_features - sum(n)  # exact total, remainder to level 0
    return n


def _extract_level(img_f, n_feats, rotate_features, quality_level,
                   min_distance):
    corners, _, valid = detect_ops.detect_corners(
        img_f, num_features=n_feats, quality_level=quality_level,
        min_distance=min_distance)
    patches = describe_ops.gather_patches(img_f, corners)
    angles = describe_ops.compute_angles(patches, rotate_features)
    bits = describe_ops.compute_descriptors(patches, angles)
    bits = torch.where(valid[..., None], bits, torch.zeros_like(bits))
    return corners, angles, bits, valid


def extract_features(img, num_features: int = 1500,
                     rotate_features: bool = True, quality_level=0.01,
                     min_distance: int = 8, num_octaves: int = 1) -> Features:
    """img [..., H, W] uint8/float tensor -> Features with num_features
    slots (per image)."""
    img_f = img.to(torch.float32)
    dev = img.device
    lead = img.shape[:-2]
    if num_octaves <= 1:
        corners, angles, bits, valid = _extract_level(
            img_f, num_features, rotate_features, quality_level,
            min_distance)
        return Features(corners=corners, angles=angles, bits=bits,
                        valid=valid,
                        octave=torch.zeros(lead + (num_features,),
                                           dtype=torch.int32, device=dev))

    budgets = _level_budgets(num_features, num_octaves)
    parts = []
    level_img = img_f
    for o in range(num_octaves):
        if o > 0:
            level_img = _downsample2(level_img)
        c, a, b, v = _extract_level(level_img, budgets[o], rotate_features,
                                    quality_level, min_distance)
        # a level-o pixel covers a 2^o block, center (x + 0.5)*2^o - 0.5
        s = float(2 ** o)
        c0 = torch.where(v[..., None], (c + 0.5) * s - 0.5,
                         torch.full_like(c, -1.0))
        parts.append((c0, a, b, v, torch.full(lead + (budgets[o],), o,
                                               dtype=torch.int32,
                                               device=dev)))
    # the feature axis: second to last of corners and bits, last of the rest
    return Features(*(torch.cat([p[i] for p in parts],
                                dim=-2 if i in (0, 2) else -1)
                      for i in range(5)))
