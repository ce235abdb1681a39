"""Image overlay rendering: detected features, matches, reprojections.

Headless equivalent of the reference's live Pangolin image overlays
(src/slam.cpp:534-771: show_detected, show_matches,
show_inliers, show_reprojections, show_epipolar). Draws onto numpy images
and writes PNGs — usable from the CLI for debugging runs frame by frame.
"""

from __future__ import annotations

import numpy as np


def _to_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        return np.stack([img] * 3, axis=-1).astype(np.uint8)
    return img.astype(np.uint8)


def _draw_cross(img, x, y, color, size=3):
    h, w = img.shape[:2]
    x, y = int(round(x)), int(round(y))
    if not (0 <= x < w and 0 <= y < h):
        return
    x0, x1 = max(0, x - size), min(w, x + size + 1)
    y0, y1 = max(0, y - size), min(h, y + size + 1)
    img[y, x0:x1] = color
    img[y0:y1, x] = color


def _draw_circle(img, x, y, color, r=4):
    h, w = img.shape[:2]
    x, y = int(round(x)), int(round(y))
    th = np.linspace(0, 2 * np.pi, 8 * r)
    for t in th:
        px, py = int(round(x + r * np.cos(t))), int(round(y + r * np.sin(t)))
        if 0 <= px < w and 0 <= py < h:
            img[py, px] = color
    _ = color


def _draw_line(img, x0, y0, x1, y1, color):
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


GREEN = np.array([0, 220, 0], np.uint8)
RED = np.array([230, 40, 40], np.uint8)
BLUE = np.array([60, 120, 255], np.uint8)
YELLOW = np.array([240, 220, 0], np.uint8)


def draw_keypoints(img, corners, valid=None, color=GREEN) -> np.ndarray:
    """show_detected: crosses at keypoint locations."""
    out = _to_rgb(img)
    corners = np.asarray(corners)
    valid = np.ones(len(corners), bool) if valid is None else np.asarray(valid)
    for (x, y), v in zip(corners, valid):
        if v:
            _draw_cross(out, x, y, color)
    return out


def draw_matches(img_l, img_r, corners_l, corners_r, match_j,
                 inlier=None) -> np.ndarray:
    """show_matches/show_inliers: side-by-side pair with match lines
    (green inliers, red others)."""
    l = _to_rgb(img_l)
    r = _to_rgb(img_r)
    h = max(l.shape[0], r.shape[0])
    out = np.zeros((h, l.shape[1] + r.shape[1], 3), np.uint8)
    out[: l.shape[0], : l.shape[1]] = l
    out[: r.shape[0], l.shape[1]:] = r
    off = l.shape[1]
    cl, cr = np.asarray(corners_l), np.asarray(corners_r)
    mj = np.asarray(match_j)
    inl = np.asarray(inlier) if inlier is not None else None
    for i, j in enumerate(mj):
        if j < 0:
            continue
        color = GREEN if (inl is None or inl[i]) else RED
        _draw_line(out, cl[i, 0], cl[i, 1], cr[j, 0] + off, cr[j, 1], color)
    return out


def draw_reprojections(img, measured, projected, valid=None) -> np.ndarray:
    """show_reprojections: measured keypoint (cross) + projected landmark
    (circle) + residual line, like the reference's outlier inspection."""
    out = _to_rgb(img)
    m = np.asarray(measured)
    p = np.asarray(projected)
    valid = np.ones(len(m), bool) if valid is None else np.asarray(valid)
    for i in range(len(m)):
        if not valid[i]:
            continue
        _draw_cross(out, m[i, 0], m[i, 1], GREEN)
        _draw_circle(out, p[i, 0], p[i, 1], BLUE)
        _draw_line(out, m[i, 0], m[i, 1], p[i, 0], p[i, 1], YELLOW)
    return out


def save_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(img)).save(path)
