"""Batched RANSAC PnP (absolute pose from 3D-2D correspondences).

Port of ``vslam_tpu/solvers/pnp.py``: H 6-point minimal samples drawn in
parallel by masked Gumbel top-k, a DLT per sample (inverse iteration for
the null vector, Newton-Schulz polar iteration for the rotation, both
sign branches scored), all hypotheses scored against all correspondences
with opengv's angular threshold, then two Gauss-Newton rounds on the best
hypothesis (inliers, then Cauchy IRLS weights over all valid matches) with
inlier re-selection. The vmapped per-hypothesis solves become a written-out
batch dimension over H. A leading sequence axis (the multi-sequence path:
S independent problems) goes through ``torch.func.vmap`` of the same
single-problem code, as the reference vmaps its tracking step: every
operation runs once over all S, none in a Python loop.

Random numbers: torch cannot reproduce ``jax.random.gumbel``. The draws
come from an explicit ``torch.Generator``; ``ransac_pnp`` also takes the
sample indices directly (``sample_idx``), which is how tests feed both
implementations the same hypotheses.
"""

from __future__ import annotations

import math

import torch

from ..geometry import lie
from ..ops.compact import top_k


def ransac_threshold(px: float = 3.0, focal: float = 500.0) -> float:
    """opengv-style angular threshold (vo_utils.h:211-212)."""
    return 1.0 - math.cos(math.atan(px / focal))


def sample_minimal(valid, num_hyp: int, sample_size: int,
                   generator: torch.Generator = None):
    """[H, S] indices of distinct valid correspondences per hypothesis
    (Gumbel top-k over the validity mask; invalid entries score -inf).
    ``valid`` [..., N] gives [..., H, S]: one draw from ``generator`` for
    all leading problems."""
    n = valid.shape[-1]
    u = torch.rand(valid.shape[:-1] + (num_hyp, n), generator=generator,
                   device=valid.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid[..., None, :], g,
                    torch.full_like(g, float("-inf")))
    return top_k(g, sample_size)[1]


def _orthogonalize(m, iters: int = 12):
    """Nearest rotation + mean scale for [..., 3, 3] (Newton-Schulz polar
    iteration; det sign follows det(m))."""
    norm = torch.sqrt(torch.sum(m * m, dim=(-2, -1), keepdim=True)) + 1e-12
    x = m / norm
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    for _ in range(iters):
        xtx = x.transpose(-1, -2) @ x
        x = x @ (1.5 * eye - 0.5 * xtx)
    scale = torch.diagonal(x.transpose(-1, -2) @ m, dim1=-2,
                           dim2=-1).sum(-1) / 3.0
    return x, scale


def _smallest_eigvec(M, iters: int = 12):
    """Eigenvector of the smallest eigenvalue of PSD matrices [..., n, n]
    by inverse iteration with a tiny shift from a fixed start. A failed
    factorization yields NaN (the caller zeroes non-finite hypotheses), as
    the reference's cho_factor does."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / n
    A = M + (1e-9 * tr + 1e-20)[..., None, None] * eye
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    v = torch.full(M.shape[:-1] + (1,), 1.0 / math.sqrt(n), dtype=M.dtype,
                   device=M.device)
    for _ in range(iters):
        # cholesky_solve's two triangular solves, spelled out: batched on
        # the card it goes to MAGMA, which allocates device memory as it
        # runs, and a CUDA graph cannot capture that
        v = torch.linalg.solve_triangular(L, v, upper=False)
        v = torch.linalg.solve_triangular(L.mT, v, upper=True)
        v = v / (torch.linalg.norm(v, dim=-2, keepdim=True) + 1e-30)
    return v[..., 0]


def _dlt_pose(points, bearings):
    """DLT for T_c_w from S >= 6 correspondences, batched.

    points [H, S, 3] world, bearings [H, S, 3]. Returns the two sign
    candidates (R [H, 2, 3, 3], t [H, 2, 3]).
    """
    f = bearings
    zeros = torch.zeros_like(points[..., 0])
    ones = torch.ones_like(points[..., 0])

    # Hartley normalization: X' = (X - c) / sc
    c = points.mean(dim=-2)                                  # [H, 3]
    sc = torch.sqrt(torch.mean(torch.sum((points - c[:, None]) ** 2,
                                         dim=-1), dim=-1)) + 1e-12  # [H]
    pts = (points - c[:, None]) / sc[:, None, None]

    fx, fy, fz = f.unbind(-1)
    X = torch.cat([pts, ones[..., None]], dim=-1)            # [H, S, 4]

    def row(a, b, cc):
        return torch.cat([a[..., None] * X, b[..., None] * X,
                          cc[..., None] * X], dim=-1)

    # [f]_x M X = 0 -> three rows per point (rank 2)
    A = torch.cat([row(zeros, -fz, fy), row(fz, zeros, -fx),
                   row(-fy, fx, zeros)], dim=-2)             # [H, 3S, 12]

    p = _smallest_eigvec(A.transpose(-1, -2) @ A)            # [H, 12]
    M = p.reshape(-1, 3, 4)

    def branch(Mb):
        Rt, lam = _orthogonalize(Mb[:, :, :3])
        lam = torch.where(torch.abs(lam) < 1e-12,
                          torch.full_like(lam, 1e-12), lam)
        t = Mb[:, :, 3] / lam[:, None] - (
            torch.einsum("hij,hj->hi", Rt, c)) / sc[:, None]
        return Rt, t * sc[:, None]

    R1, t1 = branch(M)
    R2, t2 = branch(-M)   # DLT sign ambiguity
    return torch.stack([R1, R2], dim=1), torch.stack([t1, t2], dim=1)


def _angular_error(R_cw, t_cw, points, bearings):
    """1 - cos(angle between bearing and predicted ray).

    R_cw [..., 3, 3], t_cw [..., 3]; points/bearings [N, 3] -> [..., N].
    """
    pc = torch.einsum("...ij,nj->...ni", R_cw, points) + t_cw[..., None, :]
    norm = torch.linalg.norm(pc, dim=-1)
    cos = torch.sum(pc * bearings, dim=-1) / torch.where(
        norm < 1e-12, torch.full_like(norm, 1e-12), norm)
    return 1.0 - cos


def _gn_refine(R_cw, t_cw, points, bearings, weights, iters: int = 8):
    """Gauss-Newton on T_c_w minimizing f - normalize(RX + t); right-
    multiplicative updates on SE(3), weights mask outliers.

    The Jacobian at delta = 0 is analytic (the reference differentiates
    the same residual with jax.jacfwd): with T*exp(delta), dp_c/d[ups,
    omega] = R [I | -hat(X)], and d normalize(p)/dp = (I - u u^T) / |p|.
    """
    T = lie.se3_from_Rt(R_cw, t_cw)
    eye3 = torch.eye(3, dtype=points.dtype, device=points.device)
    eye6 = torch.eye(6, dtype=points.dtype, device=points.device)
    neg_hat_x = -lie.hat(points)                          # [N, 3, 3]
    for _ in range(iters):
        pc = lie.se3_apply(T, points)
        n = torch.linalg.norm(pc, dim=-1, keepdim=True)
        n = torch.where(n < 1e-12, torch.full_like(n, 1e-12), n)
        u = pc / n
        r = bearings - u                                  # [N, 3]
        R = lie.quat_to_matrix(lie.se3_q(T))
        dp = torch.cat([R.expand(points.shape[0], 3, 3), R @ neg_hat_x],
                       dim=-1)                            # [N, 3, 6]
        proj = (eye3 - u[:, :, None] * u[:, None, :]) / n[..., None]
        J = -(proj @ dp)                                  # [N, 3, 6]
        Jw = J * weights[:, None, None]
        H = torch.einsum("nia,nib->ab", Jw, J) + 1e-9 * eye6
        g = torch.einsum("nia,ni->a", Jw, r)
        delta = -torch.linalg.solve_ex(H, g)[0]
        T = lie.se3_retract(T, delta)
    return T


def _score(R, t, points, bearings, valid, threshold):
    err = _angular_error(R, t, points, bearings)
    return (err < threshold) & valid


def ransac_pnp(points_w, bearings, valid, threshold, num_hypotheses: int = 256,
               min_inliers: int = 1, refine_iters: int = 8,
               generator: torch.Generator = None, sample_idx=None):
    """Full RANSAC-PnP. Returns (T_w_c [7], inlier_mask [N], num_inliers,
    ok).

    points_w [N, 3], bearings [N, 3] (unit, camera frame), valid [N] bool.
    ``sample_idx`` [H, 6] overrides the Gumbel draws from ``generator``.
    With a leading sequence axis on all of them ([S, N, 3], [S, N],
    ``sample_idx`` [S, H, 6]) the S problems are solved at once and every
    result has the leading S.
    """
    if sample_idx is None:
        sample_idx = sample_minimal(valid, num_hypotheses, 6, generator)
    if points_w.dim() == 3:
        return torch.func.vmap(
            lambda p, b, v, i: _ransac_pnp_one(p, b, v, i, threshold,
                                               min_inliers, refine_iters))(
            points_w, bearings, valid, sample_idx)
    return _ransac_pnp_one(points_w, bearings, valid, sample_idx, threshold,
                           min_inliers, refine_iters)


def _ransac_pnp_one(points_w, bearings, valid, sample_idx, threshold,
                    min_inliers, refine_iters):
    """``ransac_pnp`` on one problem with its [H, 6] sample indices."""
    idx = sample_idx.to(torch.int64)
    Rs, ts = _dlt_pose(points_w[idx], bearings[idx])   # [H,2,3,3], [H,2,3]
    # degenerate samples can yield NaN hypotheses; make them finite garbage
    # so they simply score zero inliers
    Rs = torch.nan_to_num(Rs, nan=0.0, posinf=0.0, neginf=0.0)
    ts = torch.nan_to_num(ts, nan=0.0, posinf=0.0, neginf=0.0)

    inls = _score(Rs, ts, points_w, bearings, valid, threshold)  # [H, 2, N]
    counts = inls.sum(dim=-1).reshape(-1)
    # first maximum, as jnp.argmax; a [1] index, as a 0-dim one would be
    # read back to the host to index with
    best = torch.argmax(counts).reshape(1)
    R_best = Rs.reshape(-1, 3, 3).index_select(0, best)[0]
    t_best = ts.reshape(-1, 3).index_select(0, best)[0]
    inl_best = inls.reshape(counts.shape[0], -1).index_select(0, best)[0]

    # GN refinement on inliers (optimize_nonlinear), then re-select
    T_cw = _gn_refine(R_best, t_best, points_w, bearings,
                      inl_best.to(points_w.dtype), refine_iters)
    err = _angular_error(lie.quat_to_matrix(lie.se3_q(T_cw)),
                         lie.se3_t(T_cw), points_w, bearings)

    # second round with IRLS (Cauchy) weights over ALL valid matches
    e_rel = err / threshold
    w2 = torch.where(valid, 1.0 / (1.0 + e_rel * e_rel),
                     torch.zeros_like(e_rel)).to(points_w.dtype)
    T_cw = _gn_refine(lie.quat_to_matrix(lie.se3_q(T_cw)), lie.se3_t(T_cw),
                      points_w, bearings, w2, refine_iters)
    inliers = _score(lie.quat_to_matrix(lie.se3_q(T_cw)), lie.se3_t(T_cw),
                     points_w, bearings, valid, threshold)
    num = inliers.sum()

    T_wc = lie.se3_inv(T_cw)
    finite = torch.all(torch.isfinite(T_wc))
    ok = (num >= min_inliers) & finite
    inliers = inliers & finite
    num = torch.where(finite, num, torch.zeros_like(num))
    T_wc = torch.nan_to_num(T_wc, nan=0.0, posinf=0.0, neginf=0.0)
    T_wc = torch.where(finite, T_wc, lie.identity_pose(T_wc.dtype,
                                                       T_wc.device))
    return T_wc, inliers, num, ok
