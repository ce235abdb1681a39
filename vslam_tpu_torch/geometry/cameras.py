"""Camera models: pinhole, extended-unified (eucm), double-sphere (ds),
Kannala-Brandt (kb4).

Port of ``vslam_tpu/geometry/cameras.py``: the same 8-parameter layout
``[fx, fy, cx, cy, p1, p2, p3, p4]`` and formulas, batched over leading
dimensions and differentiable with ``torch.func``. The kb4 unprojection
keeps the reference's fixed 5-step Newton iteration.

All functions take ``params`` with shape [..., 8] broadcasting against
point batches [..., 3] / [..., 2].
"""

from __future__ import annotations

import torch

CAMERA_MODELS = ("pinhole", "eucm", "ds", "kb4")


def _nonzero(x):
    """x with |x| < 1e-12 replaced by 1e-12 (safe divisor)."""
    return torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)


def _params(params, n):
    return [params[..., i] for i in range(n)]


# ---------------------------------------------------------------------------
# project: camera-frame 3D point -> pixel
# ---------------------------------------------------------------------------

def _project_pinhole(params, p):
    fx, fy, cx, cy = _params(params, 4)
    x, y, z = p.unbind(-1)
    zs = _nonzero(z)
    return torch.stack([fx * x / zs + cx, fy * y / zs + cy], dim=-1)


def _safe_sqrt(x):
    # the clamp keeps the sqrt derivative finite at 0 (NaN Jacobians of
    # padded / degenerate points would otherwise survive zero-weighting)
    return torch.sqrt(torch.clamp(x, min=1e-18))


def _project_eucm(params, p):
    fx, fy, cx, cy, alpha, beta = _params(params, 6)
    x, y, z = p.unbind(-1)
    d = _safe_sqrt(beta * (x * x + y * y) + z * z)
    denom = _nonzero(alpha * d + (1.0 - alpha) * z)
    return torch.stack([fx * x / denom + cx, fy * y / denom + cy], dim=-1)


def _project_ds(params, p):
    fx, fy, cx, cy, xi, alpha = _params(params, 6)
    x, y, z = p.unbind(-1)
    d1 = _safe_sqrt(x * x + y * y + z * z)
    zz = xi * d1 + z
    d2 = _safe_sqrt(x * x + y * y + zz * zz)
    denom = _nonzero(alpha * d2 + (1.0 - alpha) * zz)
    return torch.stack([fx * x / denom + cx, fy * y / denom + cy], dim=-1)


def _project_kb4(params, p):
    fx, fy, cx, cy, k1, k2, k3, k4 = _params(params, 8)
    x, y, z = p.unbind(-1)
    r = _safe_sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    tiny = r < 1e-12
    rs = torch.where(tiny, torch.ones_like(r), r)
    u = torch.where(tiny, cx, fx * d * x / rs + cx)
    v = torch.where(tiny, cy, fy * d * y / rs + cy)
    return torch.stack([u, v], dim=-1)


# ---------------------------------------------------------------------------
# unproject: pixel -> unit bearing vector in camera frame
# ---------------------------------------------------------------------------

def _normalize(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _unproject_pinhole(params, uv):
    fx, fy, cx, cy = _params(params, 4)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    return _normalize(torch.stack([mx, my, torch.ones_like(mx)], dim=-1))


def _unproject_eucm(params, uv):
    fx, fy, cx, cy, alpha, beta = _params(params, 6)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    rr = mx * mx + my * my
    inner = torch.clamp(1.0 - (2.0 * alpha - 1.0) * beta * rr, min=0.0)
    mz = (1.0 - beta * alpha * alpha * rr) / (
        alpha * torch.sqrt(inner) + (1.0 - alpha))
    return _normalize(torch.stack([mx, my, mz], dim=-1))


def _unproject_ds(params, uv):
    fx, fy, cx, cy, xi, alpha = _params(params, 6)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    rr = mx * mx + my * my
    inner = torch.clamp(1.0 - (2.0 * alpha - 1.0) * rr, min=0.0)
    mz = (1.0 - alpha * alpha * rr) / (alpha * torch.sqrt(inner) + 1.0
                                       - alpha)
    scale = (mz * xi + torch.sqrt(torch.clamp(
        mz * mz + (1.0 - xi * xi) * rr, min=0.0))) / (mz * mz + rr)
    out = torch.stack([scale * mx, scale * my, scale * mz - xi], dim=-1)
    return _normalize(out)


def _unproject_kb4(params, uv):
    fx, fy, cx, cy, k1, k2, k3, k4 = _params(params, 8)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    ru = torch.sqrt(mx * mx + my * my)

    # fixed 5 Newton steps from theta=0, like the reference
    theta = torch.zeros_like(ru)
    for _ in range(5):
        t2 = theta * theta
        d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - ru
        dd = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3
                                                           + t2 * 9.0 * k4)))
        theta = theta - d / dd

    tiny = ru < 1e-12
    rs = torch.where(tiny, torch.ones_like(ru), ru)
    st = torch.sin(theta)
    zero = torch.zeros_like(ru)
    vx = torch.where(tiny, zero, st * mx / rs)
    vy = torch.where(tiny, zero, st * my / rs)
    return _normalize(torch.stack([vx, vy, torch.cos(theta)], dim=-1))


_PROJECT = {
    "pinhole": _project_pinhole,
    "eucm": _project_eucm,
    "ds": _project_ds,
    "kb4": _project_kb4,
}
_UNPROJECT = {
    "pinhole": _unproject_pinhole,
    "eucm": _unproject_eucm,
    "ds": _unproject_ds,
    "kb4": _unproject_kb4,
}


def project(name: str, params, p):
    """Project camera-frame points [..., 3] to pixels [..., 2]."""
    return _PROJECT[name](params, p)


def unproject(name: str, params, uv):
    """Unproject pixels [..., 2] to unit bearings [..., 3]."""
    return _UNPROJECT[name](params, uv)
