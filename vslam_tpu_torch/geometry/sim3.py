"""Sim(3) similarity alignment: closed-form Horn/Umeyama + batched RANSAC.

Port of ``vslam_tpu/geometry/sim3.py`` (the reference's closed-form
alignment of matched 3D point sets, sim3.h:48-141):

- ``horn_align``: weighted closed-form Umeyama solve for (s, R, t)
  minimizing sum w_i ||dst_i - (s R src_i + t)||^2, one 3x3 SVD per
  problem, batched over leading axes and fully masked;
- ``ransac_sim3``: 3-point hypotheses in one batch, inlier counting, a
  refit on the consensus set.

The RANSAC draws come from a ``torch.Generator`` (``pnp.sample_minimal``,
Gumbel top-3 over the valid entries) or from an injected ``sample_idx``
[H, 3]: torch cannot reproduce ``jax.random``, so tests inject the
reference's draws. The SVD factors differ from the reference's by signs;
R, s and t do not.
"""

from __future__ import annotations

import dataclasses

import torch

from ..solvers import pnp


@dataclasses.dataclass
class Sim3:
    s: torch.Tensor   # [...] scale
    R: torch.Tensor   # [..., 3, 3]
    t: torch.Tensor   # [..., 3]


def sim3_apply(T: Sim3, p):
    """p [N, 3] -> s R p + t, [..., N, 3] for a batched ``T``."""
    return (T.s[..., None, None] * (p @ T.R.transpose(-1, -2))
            + T.t[..., None, :])


def sim3_inv(T: Sim3) -> Sim3:
    Rinv = T.R.transpose(-1, -2)
    s = 1.0 / T.s
    return Sim3(s=s, R=Rinv,
                t=-s[..., None] * torch.einsum("...ij,...j->...i", Rinv, T.t))


def horn_align(src, dst, weights=None, with_scale: bool = True) -> Sim3:
    """Closed-form similarity alignment (Horn 1987 / Umeyama 1991).

    src, dst [..., N, 3]; weights [..., N] (>= 0, zeros mask points out).
    Returns the Sim3 with dst ~= s R src + t; ``with_scale=False`` gives
    the SE3 special case (s = 1).
    """
    src = torch.as_tensor(src)
    dst = torch.as_tensor(dst, dtype=src.dtype, device=src.device)
    w = (torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
         if weights is None
         else torch.as_tensor(weights, dtype=src.dtype, device=src.device))
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    mu_s = torch.sum(wn[..., None] * src, dim=-2)
    mu_d = torch.sum(wn[..., None] * dst, dim=-2)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    # covariance sum_i w_i xd_i xs_i^T  (3x3)
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, xd, xs)
    U, D, Vt = torch.linalg.svd(cov)
    sgn = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], -1)
    R = (U * diag[..., None, :]) @ Vt
    if with_scale:
        var_s = torch.clamp(torch.sum(wn * torch.sum(xs * xs, -1), -1),
                            min=1e-12)
        s = torch.sum(D * diag, -1) / var_s
    else:
        s = torch.ones_like(sgn)
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return Sim3(s=s, R=R, t=t)


def ransac_sim3(src, dst, valid, threshold: float = 0.1,
                num_hypotheses: int = 128, min_inliers: int = 4,
                with_scale: bool = True, generator: torch.Generator = None,
                sample_idx=None):
    """Robust Sim(3) from 3D-3D correspondences src/dst [N, 3], valid [N].

    Samples 3 valid pairs per hypothesis (``sample_idx`` [H, 3] overrides
    the draws from ``generator``), counts inliers by aligned 3D distance
    and refits on the best consensus set. Returns (Sim3, inlier_mask [N],
    num_inliers, ok).
    """
    if sample_idx is None:
        sample_idx = pnp.sample_minimal(valid, num_hypotheses, 3, generator)
    idx = sample_idx.to(torch.int64)                       # [H, 3]

    T = horn_align(src[idx], dst[idx], with_scale=with_scale)
    d = torch.linalg.norm(sim3_apply(T, src) - dst, dim=-1)      # [H, N]
    counts = (valid[None, :] & (d < threshold)).sum(-1)
    # guard degenerate triples (collinear -> wild scale; a zero determinant
    # sign gives s = 0 or NaN)
    bad = ~torch.isfinite(T.s) | (T.s <= 1e-3) | (T.s >= 1e3)
    scores = torch.where(bad, torch.full_like(counts, -1), counts)
    best = torch.argmax(scores)             # first maximum, as jnp.argmax
    inl = valid & (d[best] < threshold)
    # refit on the consensus set, then re-select (opengv-style refine)
    T1 = horn_align(src, dst, weights=inl.to(src.dtype),
                    with_scale=with_scale)
    d1 = torch.linalg.norm(sim3_apply(T1, src) - dst, dim=-1)
    inl1 = valid & (d1 < threshold)
    n_inl = inl1.sum()
    ok = (n_inl >= min_inliers) & torch.isfinite(T1.s) & (T1.s > 1e-3)
    return T1, inl1, n_inl, ok
