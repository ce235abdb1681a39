"""Learned feature frontend bridged into the Hamming matching pipeline.

Port of ``vslam_tpu/models/learned_frontend.py``. The SuperPointTPU
detector head provides corner locations (per-cell argmax over the 65-way
softmax); the descriptor head's D-dim unit vectors are sign-binarized into
the same 256-bit {0,1} bytes the Hamming matcher and its CUDA kernels
consume, so the learned frontend is a drop-in replacement for the rBRIEF
path: the same ``Features`` contract.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend.features import Features
from ..ops.compact import top_k
from .superpoint import CELL, SuperPointTPU


def extract_features_learned(
    model: SuperPointTPU,
    img,
    num_features: int = 512,
    score_threshold: float = 0.015,
) -> Features:
    """img [H, W] uint8 tensor on the model's device -> Features (corners,
    angles=0, 256-bit desc, valid). H and W must be multiples of 8 (the
    detector cell size)."""
    x = img.to(torch.float32)[None, :, :, None] / 255.0
    with torch.no_grad():
        logits, desc = model(x)
    hc, wc = logits.shape[1:3]

    prob = torch.softmax(logits[0], dim=-1)[:, :, : CELL * CELL]
    cell_score, cell_arg = torch.max(prob, dim=-1)   # offset within cell

    vals, idx = top_k(cell_score.reshape(-1), num_features)
    cy = torch.div(idx, wc, rounding_mode="floor")
    cx = idx % wc
    off = cell_arg.reshape(-1)[idx]
    ys = (cy * CELL + torch.div(off, CELL, rounding_mode="floor")).float()
    xs = (cx * CELL + off % CELL).float()
    valid = vals > score_threshold

    d = desc[0].reshape(hc * wc, -1)[idx]            # [K, D] unit vectors
    bits = (d > 0).to(torch.uint8)                   # sign binarization
    dim = bits.shape[-1]
    if dim < 256:
        bits = bits.repeat(1, -(-256 // dim))
    bits = bits[:, :256]

    corners = torch.stack([xs, ys], dim=-1)
    corners = torch.where(valid[:, None], corners,
                          torch.full_like(corners, -1.0))
    return Features(
        corners=corners,
        angles=torch.zeros(num_features, dtype=torch.float32,
                           device=img.device),
        bits=torch.where(valid[:, None], bits, torch.zeros_like(bits)),
        valid=valid,
        octave=torch.zeros(num_features, dtype=torch.int32,
                           device=img.device))


def make_feature_fn(model: SuperPointTPU, num_features: int = 512,
                    score_threshold: float = 0.015):
    """A (img [H, W] uint8) -> Features callable for the drivers'
    ``feature_fn`` hook (``pipeline/streaming.py``, ``pipeline/slam.py``):
    the learned frontend on the model's device, under
    ``torch.inference_mode()``. A numpy image is uploaded there; a tensor
    on another device raises (the work never moves off the driver's
    device)."""
    device = next(model.parameters()).device

    def feature_fn(img):
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.ascontiguousarray(img)).to(device)
        elif img.device != device:
            raise ValueError(f"feature_fn: image on {img.device}, the model "
                             f"on {device}")
        with torch.inference_mode():
            return extract_features_learned(
                model, img, num_features=num_features,
                score_threshold=score_threshold)

    return feature_fn
