"""Corner detection: Shi-Tomasi (min-eigenvalue) response + NMS + top-K.

Port of ``vslam_tpu/ops/detect.py`` (the reference's OpenCV
``goodFeaturesToTrack`` with maxCorners=1500, qualityLevel=0.01,
minDistance=8, blockSize=3): separable 3x3 Sobel and box filters, max-pool
non-maximum suppression with -inf padding, then a block reduce and one
tie-stable top-k. Corners closer than ``EDGE_THRESHOLD`` (19) px to the
border are rejected.

Every function takes one image [H, W] or a stack [..., H, W]; each image
of a stack gets its own quality threshold and its own top-k, and the
results carry the same leading axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .compact import top_k
from .pattern import EDGE_THRESHOLD


def _shift(a, dy: int, dx: int):
    """a translated so out[y, x] = a[y+dy, x+dx], zero outside (SAME pad)."""
    h, w = a.shape[-2:]
    p = F.pad(a, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def shi_tomasi_response(img):
    """Min-eigenvalue corner response. img [..., H, W] float32 in [0, 255].

    The same sequence of shifts and adds as the reference, so the integer
    intermediate sums are exact and the response agrees bit for bit up to
    the final square root.
    """
    # Sobel X = [1,2,1]^T (x) [-1,0,1]  (cross-correlation, zero-padded SAME)
    col = _shift(img, -1, 0) + 2.0 * img + _shift(img, 1, 0)
    ix = _shift(col, 0, 1) - _shift(col, 0, -1)
    row = _shift(img, 0, -1) + 2.0 * img + _shift(img, 0, 1)
    iy = _shift(row, 1, 0) - _shift(row, -1, 0)

    def box3(a):
        v = _shift(a, -1, 0) + a + _shift(a, 1, 0)
        return _shift(v, 0, -1) + v + _shift(v, 0, 1)

    sxx = box3(ix * ix)
    syy = box3(iy * iy)
    sxy = box3(ix * iy)
    # lambda_min = (sxx+syy)/2 - sqrt(((sxx-syy)/2)^2 + sxy^2)
    half_trace = 0.5 * (sxx + syy)
    d = 0.5 * (sxx - syy)
    return half_trace - torch.sqrt(d * d + sxy * sxy)


def detect_corners(img, num_features: int = 1500, quality_level=0.01,
                   min_distance: int = 8, edge: int = EDGE_THRESHOLD):
    """Detect up to ``num_features`` Shi-Tomasi corners.

    Returns (corners [..., K, 2] float32 (x, y), response [..., K] f32,
    valid [..., K] bool), sorted by response descending. Invalid slots have
    corners (-1, -1).
    """
    img = img.to(torch.float32)
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    dev = img.device
    neg_inf = float("-inf")
    resp = shi_tomasi_response(img)

    # border mask (edge threshold): discard near-border corners
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = (xs >= edge) & (xs < w - edge) & (ys >= edge) & (ys < h - edge)
    resp = torch.where(inb, resp, neg_inf)

    # quality gate relative to max response
    max_resp = torch.amax(resp, dim=(-2, -1), keepdim=True)
    resp = torch.where(resp >= quality_level * max_resp, resp, neg_inf)

    # separable max-pool NMS (max_pool2d pads with -inf): keep local maxima
    r_nms = max(min_distance // 2, 1)
    k = 2 * r_nms + 1
    pooled = F.max_pool2d(resp.reshape(-1, 1, h, w), (k, 1), stride=1,
                          padding=(r_nms, 0))
    pooled = F.max_pool2d(pooled, (1, k), stride=1,
                          padding=(0, r_nms)).reshape(resp.shape)
    resp = torch.where(resp >= pooled, resp, neg_inf)

    # lossless candidate reduction: NMS winners are > r_nms apart
    # (Chebyshev), so an (r_nms x r_nms) block holds at most one winner
    b = r_nms
    hb, wb = -(-h // b), -(-w // b)
    resp_p = torch.full(lead + (hb * b, wb * b), float("-inf"), device=dev)
    resp_p[..., :h, :w] = resp
    blocks = resp_p.reshape(lead + (hb, b, wb, b)).transpose(-3, -2).reshape(
        lead + (hb, wb, b * b))
    blk_val, blk_arg = torch.max(blocks, dim=-1)    # first max within block

    vals, idx = top_k(blk_val.reshape(lead + (-1,)), num_features)
    by = idx // wb
    bx = idx % wb
    off = torch.gather(blk_arg.reshape(lead + (-1,)), -1, idx)
    yy = (by * b + off // b).to(torch.float32)
    xx = (bx * b + off % b).to(torch.float32)
    valid = torch.isfinite(vals)
    corners = torch.stack([xx, yy], dim=-1)
    corners = torch.where(valid[..., None], corners,
                          torch.full_like(corners, -1.0))
    return corners, torch.where(valid, vals, torch.zeros_like(vals)), valid
