"""Map viewer: plot a saved map artifact (2D + 3D trajectories, landmarks).

Equivalent of the reference's scripts/load_map.py (and consumes the same
cereal-JSON layout, so it renders maps from either system). Writes PNG
files instead of opening interactive windows (headless-friendly).

Usage: python -m vslam_tpu_torch.viz.plot_map map.json [out_prefix]
"""

from __future__ import annotations

import sys

import numpy as np


def plot(map_path: str, out_prefix: str = "map_view") -> list:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..io.map_io import load_map

    cameras, landmarks, est, gt, ate = load_map(map_path)
    lm = np.array([p for _, p in landmarks]) if landmarks else np.zeros((0, 3))
    if len(lm):
        lm = lm[np.sum(lm * lm, axis=1) < 100.0**2]

    outs = []
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot()
    if len(est):
        ax.plot(est[:, 0], est[:, 1], c="green", label="Estimated Trajectory")
    if len(gt):
        ax.plot(gt[:, 0], gt[:, 1], c="red", label="Ground-Truth Trajectory")
    ax.legend(loc="upper left")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_title(f"ATE = {ate:.3f}")
    out2d = f"{out_prefix}_2d.png"
    fig.savefig(out2d, dpi=120)
    plt.close(fig)
    outs.append(out2d)

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")
    if len(est):
        ax.plot(est[:, 0], est[:, 1], est[:, 2], c="green")
    if len(gt):
        ax.plot(gt[:, 0], gt[:, 1], gt[:, 2], c="red")
    if len(lm):
        ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], s=0.5, marker=".", c="black")
    ax.view_init(elev=-120.0, azim=-90)
    ax.grid(False)
    ax.axis("off")
    out3d = f"{out_prefix}_3d.png"
    fig.savefig(out3d, dpi=120)
    plt.close(fig)
    outs.append(out3d)
    return outs


if __name__ == "__main__":
    prefix = sys.argv[2] if len(sys.argv) > 2 else "map_view"
    for f in plot(sys.argv[1], prefix):
        print(f)
