"""Batched RANSAC relative pose (essential matrix) from bearing vectors.

Port of ``vslam_tpu/solvers/relative_pose.py``, which replaces opengv's
NISTER 5-point + sequential RANSAC of the reference's
``findInliersRansac`` (include/visnav/matching_utils.h:90-195): H
hypotheses of 8-point samples solved at once (the 8-point algorithm is a
batched linear solve), rank-2 projection, cheirality-resolved
decomposition into (R, t), epipolar-distance scoring of all hypotheses,
Gauss-Newton refinement on inliers and a final re-selection. Translation
is returned normalized.

Planar scenes make the 8-point system degenerate, so
``ransac_relative_pose_hybrid`` races a 4-point homography against the
essential model and recovers the pose from the Faugeras/Lustman
decomposition when the homography's pose has more support (ORB-SLAM's
initializer strategy).

Legacy/auxiliary, as in the reference: no caller on the stereo SLAM path
(the SfM helpers of ``pipeline/sfm.py`` are its users). The per-hypothesis
``vmap``s of the reference are a written-out batch axis over H;
``jax.jacfwd`` is ``torch.func.jacfwd`` and ``lax.scan`` a loop. Random
draws: each RANSAC function takes a ``torch.Generator`` or the sample
indices themselves (``sample_idx``; the hybrid takes one set per model in
place of ``jax.random.split``), which is how tests feed both packages the
same hypotheses.
"""

from __future__ import annotations

import torch

from ..geometry import lie
from .pnp import _smallest_eigvec, sample_minimal


def _essential_from_sample(f1, f2):
    """8-point algorithm. f1, f2 [..., S, 3] unit bearings with
    f1^T E f2 = 0 -> E [..., 3, 3] (Frobenius-normalized)."""
    A = torch.einsum("...si,...sj->...sij", f1, f2).reshape(
        f1.shape[:-1] + (9,))
    e = _smallest_eigvec(A.transpose(-1, -2) @ A)
    E = e.reshape(e.shape[:-1] + (3, 3))
    # scoring needs no projection onto the essential manifold; the
    # decomposition below re-orthogonalizes
    nrm = torch.linalg.matrix_norm(E)[..., None, None]
    return E / (nrm + 1e-12)


def _epipolar_error(E, f1, f2):
    """|f1^T E f2| per correspondence: E [..., 3, 3], f [N, 3] ->
    [..., N] (the reference scores this way, matching_utils.h:81)."""
    return torch.abs(torch.einsum("ni,...ij,nj->...n", f1, E, f2))


def _midpoint_depths(R, t, f1, f2):
    """Depths (a, b) of each pair's midpoint triangulation in frames 1 and
    2 for the pose (R, t) of frame 2 in frame 1."""
    r2 = f2 @ R.T
    f1f1 = torch.sum(f1 * f1, -1)
    r2r2 = torch.sum(r2 * r2, -1)
    f1r2 = torch.sum(f1 * r2, -1)
    f1t = f1 @ t
    r2t = r2 @ t
    det = f1f1 * r2r2 - f1r2 * f1r2
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    return (r2r2 * f1t - f1r2 * r2t) / det, (f1r2 * f1t - f1f1 * r2t) / det


def _decompose(E, f1, f2, mask):
    """E -> T_1_2 (pose of frame 2 in frame 1, translation normalized),
    with cheirality voting over the 4 candidates."""
    # E = [t]_x R ; recover t as the null vector of E^T. E E^T has rank 2,
    # so the reference's shifted Cholesky (pnp._smallest_eigvec) succeeds
    # or fails on float32 rounding; the 3x3 eigendecomposition gives the
    # same vector up to sign, and both signs are enumerated below
    t = torch.linalg.eigh(E @ E.T)[1][:, 0]    # left null vector
    t = t / (torch.linalg.vector_norm(t) + 1e-12)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)

    # closed-form rotation extraction (Horn): for a consistent pair
    # (E, t) with E = [t]_x R and |t| = 1,  R = -[t]_x E + adj(E)^T.
    # Inconsistent sign pairs give non-rotations that the polar projection
    # and the cheirality vote reject.
    def rot_for(E_c, tv):
        cof = torch.stack([torch.linalg.cross(E_c[(i + 1) % 3],
                                              E_c[(i + 2) % 3])
                           for i in range(3)])  # adj(E)^T, row by row
        M = -lie.hat(tv) @ E_c + cof
        # polar projection (Newton-Schulz; the Frobenius normalization
        # keeps the spectral norm <= 1, inside its convergence region)
        x = M / (torch.sqrt(torch.sum(M * M)) + 1e-12)
        for _ in range(14):
            x = x @ (1.5 * eye - 0.5 * x.T @ x)
        return x * torch.sign(torch.linalg.det(x))

    cands = [(rot_for(se * E, st * t), st * t)
             for se in (1.0, -1.0) for st in (1.0, -1.0)]

    def score(R, tv):
        a, b = _midpoint_depths(R, tv, f1, f2)
        return torch.sum((a > 0) & (b > 0) & mask)

    best = torch.argmax(torch.stack([score(R, tv) for R, tv in cands]))
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return lie.se3_from_Rt(Rs[best], ts[best])


def _essential_of(T):
    """[t/|t|]_x R of a pose."""
    t = lie.se3_t(T)
    tn = t / (torch.linalg.vector_norm(t) + 1e-12)
    return lie.hat(tn) @ lie.quat_to_matrix(lie.se3_q(T))


def _gn_refine_rel(T_1_2, f1, f2, weights, iters: int = 8):
    """GN on the epipolar residual f1^T E(T) f2 over se3 (t renormalized)."""

    def resid(T):
        return torch.einsum("ni,ij,nj->n", f1, _essential_of(T),
                            f2) * weights

    z = torch.zeros(6, dtype=f1.dtype, device=f1.device)
    eye6 = torch.eye(6, dtype=f1.dtype, device=f1.device)
    T = T_1_2
    for _ in range(iters):
        J = torch.func.jacfwd(
            lambda delta, T=T: resid(lie.se3_retract(T, delta)))(z)
        r = resid(T)
        H = J.T @ J + 1e-9 * eye6
        delta = -torch.nan_to_num(torch.linalg.solve_ex(H, J.T @ r)[0])
        T = lie.se3_retract(T, delta)
    t = lie.se3_t(T)
    return lie.se3_make(t / (torch.linalg.vector_norm(t) + 1e-12),
                        lie.se3_q(T))


# ---------------------------------------------------------------------------
# Homography path (planar scenes)
# ---------------------------------------------------------------------------

def _homography_from_sample(f1, f2):
    """4-point DLT: H with f1 ~ H f2 (bearings, homogeneous). f [..., S, 3]
    -> H [..., 3, 3] (Frobenius-normalized)."""
    zeros = torch.zeros_like(f1)
    # rows from f1 x (H f2) = 0 (two independent equations per point)
    r1 = torch.cat([zeros, -f1[..., 2:3] * f2, f1[..., 1:2] * f2], dim=-1)
    r2 = torch.cat([f1[..., 2:3] * f2, zeros, -f1[..., 0:1] * f2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                   # [..., 2S, 9]
    h = _smallest_eigvec(A.transpose(-1, -2) @ A)
    H = h.reshape(h.shape[:-1] + (3, 3))
    nrm = torch.linalg.matrix_norm(H)[..., None, None]
    return H / (nrm + 1e-12)


def _homography_error(H, f1, f2):
    """Sine of the angle between f1 and H f2 (sphere transfer error):
    H [..., 3, 3], f [N, 3] -> [..., N]."""
    Hf2 = torch.einsum("...ij,nj->...ni", H, f2)
    Hf2 = Hf2 / (torch.linalg.vector_norm(Hf2, dim=-1, keepdim=True)
                 + 1e-12)
    return torch.linalg.vector_norm(
        torch.linalg.cross(f1.expand_as(Hf2), Hf2), dim=-1)


def _decompose_homography(H, f1, f2, mask):
    """Faugeras/Lustman SVD decomposition of a calibrated homography.

    H ~ R + t n^T / d. Enumerates the 8 (R, t, n) solutions and picks the
    one with the best cheirality + plane-visibility vote. Returns T_1_2
    (translation normalized). The singular vectors' signs may differ from
    another library's; the enumeration covers every sign choice.
    """
    U, D, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d3 = D[0] / D[1], D[2] / D[1]

    eps = 1e-9
    denom = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - 1.0) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((1.0 - d3 * d3) / denom, min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    cands = []
    # case d' = +d2: R' is a y-rotation
    sin_t = (d1 - d3) * x1 * x3
    cos_t = d1 * x3 * x3 + d3 * x1 * x1
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = mat([[cos_t, zero, -st], [zero, one, zero],
                      [st, zero, cos_t]])
            tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3])
            np_ = torch.stack([e1 * x1, zero, e3 * x3])
            cands.append((Rp, tp, np_))
    # case d' = -d2: R' is a y-rotation composed with diag(1,-1,-1)
    sin_p = (d1 + d3) * x1 * x3
    cos_p = d3 * x1 * x1 - d1 * x3 * x3
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = mat([[cos_p, zero, sp], [zero, -one, zero],
                      [sp, zero, -cos_p]])
            tp = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3])
            np_ = torch.stack([e1 * x1, zero, e3 * x3])
            cands.append((Rp, tp, np_))

    def world(Rp, tp, np_):
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t / (torch.linalg.vector_norm(t) + 1e-12), Vt.T @ np_

    def score(Rp, tp, np_):
        R, t, n = world(Rp, tp, np_)
        a, b = _midpoint_depths(R, t, f1, f2)
        # plane must be in front of camera 2: n^T f2 > 0 for inliers
        front = (f2 @ n) > 0
        return torch.sum((a > 0) & (b > 0) & front & mask)

    best = torch.argmax(torch.stack([score(*c) for c in cands]))
    worlds = [world(*c) for c in cands]
    Rs = torch.stack([w[0] for w in worlds])
    ts = torch.stack([w[1] for w in worlds])
    return lie.se3_from_Rt(Rs[best], ts[best])


def _draws(valid, num_hypotheses, size, generator, sample_idx):
    if sample_idx is None:
        sample_idx = sample_minimal(valid, num_hypotheses, size, generator)
    return sample_idx.long()


def ransac_homography(f1, f2, valid, threshold: float = 1e-3,
                      num_hypotheses: int = 256, min_inliers: int = 16,
                      generator: torch.Generator = None, sample_idx=None):
    """Robust calibrated homography + pose. ``sample_idx`` [H, 4]
    overrides the draws from ``generator``. Returns (T_1_2, H, inliers,
    num, ok)."""
    idx = _draws(valid, num_hypotheses, 4, generator, sample_idx)
    Hs = _homography_from_sample(f1[idx], f2[idx])           # [H, 3, 3]
    errs = _homography_error(Hs, f1, f2)                      # [H, N]
    inl = (errs < threshold) & valid[None, :]
    best = torch.argmax(inl.sum(dim=1))
    H_best = Hs[best]
    inl_best = inl[best]
    T = _decompose_homography(H_best, f1, f2, inl_best)
    num = inl_best.sum()
    ok = (num >= min_inliers) & torch.all(torch.isfinite(T))
    return (T, H_best, inl_best & ok,
            torch.where(ok, num, torch.zeros_like(num)), ok)


def ransac_relative_pose(f1, f2, valid, threshold: float = 1e-3,
                         num_hypotheses: int = 256, min_inliers: int = 16,
                         refine_iters: int = 8,
                         generator: torch.Generator = None, sample_idx=None):
    """f1, f2 [N, 3] unit bearings. ``sample_idx`` [H, 8] overrides the
    draws from ``generator``. Returns (T_1_2 [7], inliers [N], num, ok).
    Translation normalized."""
    idx = _draws(valid, num_hypotheses, 8, generator, sample_idx)
    Es = _essential_from_sample(f1[idx], f2[idx])            # [H, 3, 3]
    errs = _epipolar_error(Es, f1, f2)                        # [H, N]
    inl = (errs < threshold) & valid[None, :]
    best = torch.argmax(inl.sum(dim=1))
    inl_best = inl[best]

    T = _decompose(Es[best], f1, f2, inl_best)
    T = _gn_refine_rel(T, f1, f2, inl_best.to(f1.dtype), refine_iters)

    # re-select with the refined model (selectWithinDistance semantics)
    err = _epipolar_error(_essential_of(T), f1, f2)
    inliers = (err < threshold) & valid
    num = inliers.sum()
    ok = (num >= min_inliers) & torch.all(torch.isfinite(T))
    # reference clears inliers when below the minimum (matching_utils.h:192)
    return (T, inliers & ok, torch.where(ok, num, torch.zeros_like(num)),
            ok)


def ransac_relative_pose_hybrid(f1, f2, valid, threshold: float = 1e-3,
                                num_hypotheses: int = 256,
                                min_inliers: int = 16, refine_iters: int = 8,
                                generator: torch.Generator = None,
                                sample_idx_e=None, sample_idx_h=None):
    """Race essential vs homography models (ORB-SLAM initializer flow).

    Planar scenes break the 8-point essential solve (rank-deficient DLT);
    there the homography's Faugeras decomposition supplies the pose. Each
    model draws from ``generator`` unless its indices are given
    (``sample_idx_e`` [H, 8], ``sample_idx_h`` [H, 4]). Returns
    (T_1_2, inliers, num, ok, used_homography).
    """
    T_e, inl_e, n_e, ok_e = ransac_relative_pose(
        f1, f2, valid, threshold=threshold, num_hypotheses=num_hypotheses,
        min_inliers=min_inliers, refine_iters=refine_iters,
        generator=generator, sample_idx=sample_idx_e)
    T_h, _, inl_h, n_h, ok_h = ransac_homography(
        f1, f2, valid, threshold=threshold, num_hypotheses=num_hypotheses,
        min_inliers=min_inliers, generator=generator,
        sample_idx=sample_idx_h)
    # refine the H pose on its inliers with the epipolar GN (the pose is
    # epipolar-consistent regardless of which model found it)
    T_h = _gn_refine_rel(T_h, f1, f2, inl_h.to(f1.dtype), refine_iters)

    # A degenerate-plane E still has ~zero epipolar error on every plane
    # point, so inlier COUNTS cannot discriminate, but the pose decomposed
    # from it is wrong. Select by pose support: cheirality-positive
    # epipolar inliers.
    def pose_support(T):
        R = lie.quat_to_matrix(lie.se3_q(T))
        t = lie.se3_t(T)
        t = t / (torch.linalg.vector_norm(t) + 1e-12)
        epi = _epipolar_error(lie.hat(t) @ R, f1, f2) < threshold
        a, b = _midpoint_depths(R, t, f1, f2)
        good = epi & (a > 0) & (b > 0) & valid
        return good.sum(), good

    s_e, good_e = pose_support(T_e)
    s_h, good_h = pose_support(T_h)
    use_h = ok_h & ((s_h > s_e) | ~ok_e)
    T = torch.where(use_h, T_h, T_e)
    inliers = torch.where(use_h, good_h, good_e)
    num = torch.where(use_h, s_h, s_e)
    ok = torch.where(use_h, ok_h, ok_e) & (num >= min_inliers)
    return T, inliers, num, ok, use_h
