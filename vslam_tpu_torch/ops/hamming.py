"""Brute-force Hamming descriptor matching.

Port of ``vslam_tpu/ops/hamming.py``. Two functions carry the matching of
the VO main path, and each has a hand-written CUDA kernel beside a plain
PyTorch version of the same function:

- ``landmark_top2`` (guided landmark matching stats, every frame) — the
  port of the Pallas ``_lm_top2_kernel``;
- ``hamming_top2`` (per-row top-2 of descriptor A against B, twice per
  keyframe) — the port of the Pallas ``_top2_kernel``.

``match_landmarks`` and ``match_descriptors`` choose by the device of
their inputs: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel (``ops/cuda_hamming.py``) or raises. Both are held to the
reference's CPU path, which is what its Tier-1 tests pin: in particular
``any_candidate`` of ``landmark_top2`` is "some valid landmark inside the
2D gate", whatever the validity of that landmark's descriptor bank (the
reference's Pallas path also required a valid bank slot).

The plain distance matrix is a float32 product of +/-1 vectors:
dot(sa, sb) = 256 - 2 * hamming(a, b), and every partial sum is an integer
of magnitude <= 256, so the f32 product is exact (with TF32 off, see
``vslam_tpu_torch/__init__.py``).
"""

from __future__ import annotations

import numpy as np
import torch

# Value used for masked-out entries: the reference initializes best
# distances to 256, so padding with 256 reproduces its semantics when fewer
# than 2 real candidates exist.
PAD_DIST = 256


def signed(bits):
    """{0,1} uint8 bits [..., 256] -> +/-1 float32."""
    return bits.to(torch.float32) * 2.0 - 1.0


def distance_matrix(bits_a, bits_b, valid_a=None, valid_b=None):
    """bits_a [N, 256], bits_b [M, 256] {0,1} -> [N, M] int32 distances in
    [0, 256]; invalid rows/cols are PAD_DIST. Leading axes are batch axes."""
    dot = signed(bits_a) @ signed(bits_b).transpose(-1, -2)
    d = ((256.0 - dot) * 0.5).to(torch.int32)
    pad = torch.full_like(d, PAD_DIST)
    if valid_a is not None:
        d = torch.where(valid_a[..., :, None], d, pad)
    if valid_b is not None:
        d = torch.where(valid_b[..., None, :], d, pad)
    return d


def _top2_min(d, dim):
    """(best, second-best, argmin) along dim; argmin takes the first
    occurrence, an equal value elsewhere remains as second-best."""
    m = torch.movedim(d, dim, -1)
    arg = torch.argmin(m, dim=-1)
    b1 = torch.gather(m, -1, arg[..., None])[..., 0]
    iota = torch.arange(m.shape[-1], device=d.device)
    b2 = torch.min(torch.where(iota == arg[..., None],
                               torch.full_like(m, PAD_DIST), m), dim=-1).values
    return b1, b2, arg


def _ratio_ok(b1, b2, threshold, ratio):
    """best < threshold and not(second < best * ratio)."""
    return (b1 < threshold) & ~(b2.to(torch.float32) < b1 * ratio)


def match_table(dist, threshold=70, ratio=1.2):
    """Mutual best matches with threshold + second-best ratio tests.

    dist [N, M] int32 (PAD_DIST-filled where invalid). Returns (match_j [N]
    int64 with -1 for unmatched, accepted [N] bool).
    """
    rb1, rb2, row_arg = _top2_min(dist, 1)
    cb1, cb2, col_arg = _top2_min(dist, 0)
    return _mutual(rb1, rb2, row_arg, cb1, cb2, col_arg, threshold, ratio)


def _mutual(rb1, rb2, row_arg, cb1, cb2, col_arg, threshold, ratio):
    n = rb1.shape[0]
    j = row_arg.to(torch.int64)
    if cb1.shape[0] == 0:  # no B rows: nothing to match (and no j to read)
        return torch.full_like(j, -1), torch.zeros_like(j, dtype=torch.bool)
    row_ok = _ratio_ok(rb1, rb2, threshold, ratio)
    col_ok = _ratio_ok(cb1[j], cb2[j], threshold, ratio)
    mutual = col_arg.to(torch.int64)[j] == torch.arange(n, device=j.device)
    accepted = row_ok & col_ok & mutual
    return torch.where(accepted, j, torch.full_like(j, -1)), accepted


def hamming_top2_plain(bits_a, bits_b, valid_a, valid_b):
    """Per-row (best, second, argmin) Hamming stats of A against the valid
    rows of B; invalid A rows and rows with no valid candidate give 256
    (argmin 0). Returns int32 [N] x3."""
    d = distance_matrix(bits_a, bits_b, valid_a, valid_b)
    if d.shape[1] == 0:
        z = torch.full((d.shape[0],), PAD_DIST, dtype=torch.int32,
                       device=d.device)
        return z, z.clone(), torch.zeros_like(z)
    b1, b2, arg = _top2_min(d, 1)
    return b1, b2, arg.to(torch.int32)


def gate_radius_sq(max_dist_2d):
    """The 2D gate's squared radius, squared in float32 as the reference
    squares its float32 scalar."""
    r = np.float32(max_dist_2d)
    return float(r * r)


def landmark_top2_plain(kp_bits, kp_valid, kp_xy, bank_bits, bank_valid,
                        lm_proj_xy, lm_valid, max_dist_2d):
    """Guided landmark matching stats (the reference's CPU path).

    kp_bits [N, 256], kp_xy [N, 2]; bank_bits [P, B, 256] with validity
    [P, B]; lm_proj_xy [P, 2], lm_valid [P]; or every tensor with the same
    leading sequence axis [S, ...] (each sequence is its own problem). The
    distance to a landmark is the min over its valid bank slots (PAD_DIST
    if none), PAD_DIST outside the gate ||kp - proj||^2 < r^2. Returns
    (best, second, arg) int32 [N] and any_candidate bool [N] (some valid
    landmark inside the gate), or [S, N] each.
    """
    n = kp_bits.shape[-2]
    p, b = bank_bits.shape[-3], bank_bits.shape[-2]
    lead = kp_bits.shape[:-2]
    flat_bits = bank_bits.reshape(lead + (p * b, 256))
    flat_valid = (bank_valid.reshape(lead + (p * b,))
                  & lm_valid.repeat_interleave(b, dim=-1))
    d = distance_matrix(kp_bits, flat_bits, kp_valid, flat_valid)
    d = d.reshape(lead + (n, p, b)).min(dim=-1).values if b else \
        torch.full(lead + (n, p), PAD_DIST, dtype=torch.int32,
                   device=d.device)

    diff = kp_xy[..., :, None, :] - lm_proj_xy[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    gate = ((d2 < gate_radius_sq(max_dist_2d)) & lm_valid[..., None, :]
            & kp_valid[..., :, None])
    d = torch.where(gate, d, torch.full_like(d, PAD_DIST))
    if p == 0:
        z = torch.full(lead + (n,), PAD_DIST, dtype=torch.int32,
                       device=d.device)
        return z, z.clone(), torch.zeros_like(z), gate.any(dim=-1)
    b1, b2, arg = _top2_min(d, -1)
    return b1, b2, arg.to(torch.int32), gate.any(dim=-1)


def _use_kernel(t) -> bool:
    """CUDA tensors take the hand-written kernel, CPU tensors the plain
    version; nothing else is accepted (and nothing falls back)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} for Hamming matching")


def landmark_top2(kp_bits, kp_valid, kp_xy, bank_bits, bank_valid,
                  lm_proj_xy, lm_valid, max_dist_2d):
    if _use_kernel(kp_bits):
        from . import cuda_hamming

        return cuda_hamming.landmark_top2(kp_bits, kp_valid, kp_xy,
                                          bank_bits, bank_valid, lm_proj_xy,
                                          lm_valid, max_dist_2d)
    return landmark_top2_plain(kp_bits, kp_valid, kp_xy, bank_bits,
                               bank_valid, lm_proj_xy, lm_valid, max_dist_2d)


def hamming_top2(bits_a, bits_b, valid_a, valid_b):
    if _use_kernel(bits_a):
        from . import cuda_hamming

        return cuda_hamming.hamming_top2(bits_a, bits_b, valid_a, valid_b)
    return hamming_top2_plain(bits_a, bits_b, valid_a, valid_b)


def match_descriptors(bits_a, bits_b, valid_a, valid_b, threshold=70,
                      ratio=1.2):
    """Mutual ratio-tested matches (match_r [N] int64 or -1, accepted [N]).

    On the card: the top-2 kernel in both directions, then the mutual,
    threshold and ratio tests. On the CPU: the distance matrix and
    ``match_table``. Same semantics.
    """
    if _use_kernel(bits_a):
        row = hamming_top2(bits_a, bits_b, valid_a, valid_b)
        col = hamming_top2(bits_b, bits_a, valid_b, valid_a)
        return _mutual(*row, *col, threshold, ratio)
    d = distance_matrix(bits_a, bits_b, valid_a, valid_b)
    return match_table(d, threshold, ratio)


def match_landmarks(kp_bits, kp_valid, lm_bank_bits, lm_bank_valid, kp_xy,
                    lm_proj_xy, lm_valid, max_dist_2d=20.0, threshold=70,
                    ratio=1.2):
    """Guided 2D-radius landmark matching (reference vo_utils.h:83-167).

    Accept: a gated candidate exists, best < threshold and not(second <
    best * ratio); no cross-check. Returns (match_lm [N] int64 index into
    the P axis or -1, accepted [N], any_candidate [N]). Every tensor may
    carry the same leading sequence axis [S, ...]; the results then do
    too, and on the card the S sequences are one kernel launch.
    """
    b1, b2, arg, any_c = landmark_top2(
        kp_bits, kp_valid, kp_xy, lm_bank_bits, lm_bank_valid, lm_proj_xy,
        lm_valid, max_dist_2d)
    ok = any_c & _ratio_ok(b1, b2, threshold, ratio)
    arg = arg.to(torch.int64)
    return torch.where(ok, arg, torch.full_like(arg, -1)), ok, any_c
