"""Descriptor matching of a frame against stored keyframes, for loop
closure and relocalization.

Port of ``vslam_tpu/loop/matching.py``. The current frame's descriptors
are matched against a stored keyframe's (candidate keypoints first, the
reference's argument order in sim3.h:252-253 and tracking.h:283-285, so
the (candidate_feat, current_feat) pair direction is identical). Each
slot is one ``hamming.match_descriptors`` call: on the card the descriptor
top-2 kernel in both directions (two launches per slot, counted in
``ops/cuda_hamming.LAUNCHES``), on the CPU its plain version. The
reference's ``lax.map`` over slots is a loop here.
"""

from __future__ import annotations

import torch

from ..core.state import KeyframeState
from ..ops import describe as describe_ops
from ..ops import hamming


def match_vs_keyframe(cur_bits, cur_valid, kf: KeyframeState, slot, cam,
                      threshold=70, ratio=1.2):
    """Returns match_cur [N_kf] int32: current-feature index per candidate
    keyframe feature (-1 unmatched)."""
    slot, cam = int(slot), int(cam)
    kf_bits = describe_ops.unpack_bits(kf.desc[slot, cam])
    mj, acc = hamming.match_descriptors(
        kf_bits, cur_bits, kf.kp_valid[slot, cam], cur_valid,
        threshold=threshold, ratio=ratio)
    return torch.where(acc, mj, torch.full_like(mj, -1)).to(torch.int32)


def match_vs_keyframes(cur_bits, cur_valid, kf: KeyframeState, slots, cam,
                       threshold=70, ratio=1.2):
    """``match_vs_keyframe`` over a sequence of keyframe slots. Returns
    [S, N_kf] int32."""
    rows = [match_vs_keyframe(cur_bits, cur_valid, kf, s, cam, threshold,
                              ratio) for s in slots]
    if not rows:
        return torch.empty((0, kf.desc.shape[2]), dtype=torch.int32,
                           device=kf.desc.device)
    return torch.stack(rows)
