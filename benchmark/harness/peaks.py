"""NVIDIA H100 peaks and the least time of the two Hamming kernels.

Copied from ``chip_smoke.py`` (``bound``, ``hamming_bound``,
``landmark_bound``) so that a later roofline metric reads the yardstick
from here. The bounds take a call's inputs; a replayed CUDA graph does
not show them to the harness, so no metric reads these yet (PERF.md,
Open questions).
"""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12   # int8 tensor cores, taken for 1-bit products
HBM_BYTES = 80e9


def bound(nbytes, ops_s):
    """(bound_ms, bound_by): bytes over the memory rate against the
    operations' seconds at their peak rates, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, ops_s) * 1e3,
            "bytes" if t_bytes >= ops_s else "operations")


def hamming_bound(va, vb):
    """K2 (descriptor top-2): read the valid rows of A and B (256 {0,1}
    bytes each) and both validity vectors, write three int32 per row of A;
    a 256-bit distance (512 operations) per valid pair."""
    na, nb = int(va.sum()), int(vb.sum())
    nbytes = 256 * (na + nb) + va.numel() + vb.numel() + 12 * va.numel()
    return bound(nbytes, na * nb * 512 / INT8_OPS_PER_S)


def gate_radius_sq(max_dist_2d):
    r = np.float32(max_dist_2d)
    return float(r * r)


def landmark_bound(kv, kxy, bv, lxy, lv, max_dist_2d):
    """K1 (guided landmark top-2), one sequence: read every validity and
    xy, the descriptor bytes of keypoints that gate a landmark and of the
    valid bank slots of gated landmarks, write three int32 and a bool per
    keypoint; the gate test (6 float32 operations) per valid keypoint and
    landmark, a 256-bit distance per gated pair and valid slot."""
    diff = kxy[:, None, :] - lxy[None, :, :]
    gate = ((torch.sum(diff * diff, dim=-1) < gate_radius_sq(max_dist_2d))
            & lv[None, :] & kv[:, None])
    n, p = gate.shape
    rows = int(gate.any(dim=1).sum())
    slots = int((bv & gate.any(dim=0)[:, None]).sum())
    pair_slots = int((gate.float() @ bv.float()).sum())
    nbytes = (256 * (rows + slots) + n * (1 + 8) + p * (1 + 8) + bv.numel()
              + 13 * n)
    ops_s = (6 * int(kv.sum()) * int(lv.sum()) / F32_OPS_PER_S
             + 512 * pair_slots / INT8_OPS_PER_S)
    return bound(nbytes, ops_s)
