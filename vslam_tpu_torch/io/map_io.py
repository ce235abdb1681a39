"""Map artifact serialization — cereal-JSON compatible.

Copy of ``vslam_tpu/io/map_io.py`` (host code). Writes the same JSON
layout the reference's ``save_map_file`` emits (slam.cpp:1791-1822 via
serialization.h:155-203):
  value0: cameras  [{key: {value0: frame_id, value1: cam_id},
                     value: {"c.T_w_c": {px..qw}}}]
  value1: landmarks [{key: track_id, value: {"lm.p": {value0..value2}}}]
  value2: estimated trajectory [{value0..value2}]
  value3: ground-truth trajectory [{value0..value2}]
  value4: ATE (float)
so the reference's ``scripts/load_map.py`` can consume our maps unchanged.
"""

from __future__ import annotations

import json
from typing import Sequence, Tuple

import numpy as np


def _pose_dict(T) -> dict:
    keys = ["px", "py", "pz", "qx", "qy", "qz", "qw"]
    return {k: float(v) for k, v in zip(keys, np.asarray(T))}


def _vec3_dict(v) -> dict:
    v = np.asarray(v)
    return {"value0": float(v[0]), "value1": float(v[1]), "value2": float(v[2])}


def save_map(
    path: str,
    cameras: Sequence[Tuple[Tuple[int, int], np.ndarray]],
    landmarks: Sequence[Tuple[int, np.ndarray]],
    est_t_w_i: np.ndarray,
    gt_t_w_i: np.ndarray,
    ate: float,
) -> None:
    """cameras: [((frame_id, cam_id), T_w_c[7])], landmarks: [(tid, p[3])]."""
    data = {
        "value0": [
            {"key": {"value0": int(fid), "value1": int(cid)},
             "value": {"c.T_w_c": _pose_dict(T)}}
            for (fid, cid), T in cameras
        ],
        "value1": [
            {"key": int(tid), "value": {"lm.p": _vec3_dict(p)}}
            for tid, p in landmarks
        ],
        "value2": [_vec3_dict(p) for p in np.asarray(est_t_w_i)],
        "value3": [_vec3_dict(p) for p in np.asarray(gt_t_w_i)],
        "value4": float(ate),
    }
    with open(path, "w") as f:
        json.dump(data, f)


def load_map(path: str):
    """Inverse of save_map. Returns (cameras, landmarks, est, gt, ate)."""
    with open(path) as f:
        data = json.load(f)
    cameras = []
    for item in data["value0"]:
        k = item["key"]
        p = item["value"]["c.T_w_c"]
        T = np.array([p["px"], p["py"], p["pz"], p["qx"], p["qy"], p["qz"], p["qw"]])
        cameras.append(((int(k["value0"]), int(k["value1"])), T))
    landmarks = []
    for item in data["value1"]:
        p = item["value"]["lm.p"]
        landmarks.append((int(item["key"]),
                          np.array([p["value0"], p["value1"], p["value2"]])))
    est = np.array([[p["value0"], p["value1"], p["value2"]] for p in data["value2"]])
    gt = np.array([[p["value0"], p["value1"], p["value2"]] for p in data["value3"]])
    return cameras, landmarks, est, gt, float(data["value4"])
