"""SO(3)/SE(3) Lie group operations on quaternion-parameterized poses.

Port of ``vslam_tpu/geometry/lie.py``. Pose storage layout is a length-7
vector ``[tx, ty, tz, qx, qy, qz, qw]``; tangent (twist) layout is
``[upsilon (3), omega (3)]`` with the right-multiplicative retraction
T * exp(delta). All functions broadcast over leading batch dimensions and
are safe under ``torch.func`` transforms (no in-place ops, no host reads).
"""

from __future__ import annotations

import torch

# Small-angle switch point (same as the reference): theta^2 below this uses
# Taylor series.
_EPS = 1e-8


def identity_pose(dtype=torch.float32, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype,
                        device=device)


# ---------------------------------------------------------------------------
# Quaternion primitives (xyzw layout)
# ---------------------------------------------------------------------------

def quat_mul(q1, q2):
    """Hamilton product q1 * q2, xyzw layout, batched."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    # v' = v + 2 qw (qv x v) + 2 qv x (qv x v)
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q):
    """[..., 4] xyzw -> [..., 3, 3] rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """[..., 3, 3] rotation matrix -> [..., 4] xyzw quaternion.

    Shepperd's method, branch-free: all four constructions are computed and
    the numerically best one is selected per element.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = _safe_sqrt(1.0 + tr) * 2.0  # 4*qw
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0,
                      s0 / 4.0], -1)
    s1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0  # 4*qx
    q1 = torch.stack([s1 / 4.0, (m01 + m10) / s1, (m02 + m20) / s1,
                      (m21 - m12) / s1], -1)
    s2 = _safe_sqrt(1.0 - m00 + m11 - m22) * 2.0  # 4*qy
    q2 = torch.stack([(m01 + m10) / s2, s2 / 4.0, (m12 + m21) / s2,
                      (m02 - m20) / s2], -1)
    s3 = _safe_sqrt(1.0 - m00 - m11 + m22) * 2.0  # 4*qz
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, s3 / 4.0,
                      (m10 - m01) / s3], -1)

    cond0 = tr > 0.0
    cond1 = ~cond0 & (m00 > m11) & (m00 > m22)
    cond2 = ~cond0 & (~(m00 > m11) | ~(m00 > m22)) & (m11 > m22)
    cond2 = ~cond1 & cond2
    q = torch.where(cond0[..., None], q0,
                    torch.where(cond1[..., None], q1,
                                torch.where(cond2[..., None], q2, q3)))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3) exp/log
# ---------------------------------------------------------------------------

def so3_exp_quat(omega):
    """Axis-angle [..., 3] -> quaternion [..., 4] (double-where Taylor
    switch, so forward-mode derivatives stay finite at omega = 0)."""
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([k * omega, w], dim=-1)


def so3_log(q):
    """Quaternion [..., 4] -> axis-angle [..., 3]. Angle in (-pi, pi]."""
    q = torch.where(q[..., 3:4] < 0, -q, q)  # shortest arc
    qv = q[..., :3]
    qw = torch.clamp(q[..., 3:4], -1.0, 1.0)
    n_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = n_sq < 1e-14
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    theta = 2.0 * torch.atan2(n, qw)
    k = torch.where(small, 2.0 / torch.clamp(qw, min=1e-12), theta / n)
    return k * qv


def hat(w):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = w.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _so3_left_jacobian(omega):
    """V(omega): t = V * upsilon in se3_exp. [..., 3] -> [..., 3, 3]."""
    theta_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    W = hat(omega)
    W2 = W @ W
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (safe_sq * theta))
    return _eye3(omega) + a * W + b * W2


def _so3_left_jacobian_inv(omega):
    """V(omega)^-1, closed form."""
    theta_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    W = hat(omega)
    W2 = W @ W
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half_theta * torch.cos(half_theta) / torch.sin(half_theta))
        / safe_sq,
    )
    return _eye3(omega) - 0.5 * W + cot_term * W2


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_t(T):
    return T[..., :3]


def se3_q(T):
    return T[..., 3:7]


def se3_make(t, q):
    return torch.cat([t, q], dim=-1)


def se3_mul(T1, T2):
    """Compose T1 * T2."""
    q = quat_mul(se3_q(T1), se3_q(T2))
    t = se3_t(T1) + quat_rotate(se3_q(T1), se3_t(T2))
    return se3_make(t, quat_normalize(q))


def se3_inv(T):
    qi = quat_conj(se3_q(T))
    ti = -quat_rotate(qi, se3_t(T))
    return se3_make(ti, qi)


def se3_apply(T, p):
    """Apply T [..., 7] to points p [..., 3]."""
    return quat_rotate(se3_q(T), p) + se3_t(T)


def se3_exp(xi):
    """Twist [..., 6] = [upsilon, omega] -> pose [..., 7]."""
    ups, omega = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(omega)
    V = _so3_left_jacobian(omega)
    t = torch.einsum("...ij,...j->...i", V, ups)
    return se3_make(t, q)


def se3_log(T):
    """Pose [..., 7] -> twist [..., 6] = [upsilon, omega]."""
    omega = so3_log(se3_q(T))
    Vinv = _so3_left_jacobian_inv(omega)
    ups = torch.einsum("...ij,...j->...i", Vinv, se3_t(T))
    return torch.cat([ups, omega], dim=-1)


def se3_retract(T, delta):
    """Right-multiplicative retraction T * exp(delta)."""
    return se3_mul(T, se3_exp(delta))


def se3_matrix(T):
    """[..., 7] -> [..., 4, 4] homogeneous matrix."""
    R = quat_to_matrix(se3_q(T))
    t = se3_t(T)[..., :, None]
    top = torch.cat([R, t], dim=-1)
    bottom = T.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        T.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_from_Rt(R, t):
    return se3_make(t, matrix_to_quat(R))
