"""Camera calibration loading — cereal-JSON schema compatible.

Reads the same ``calibration_file/euroc_*_ds_calib.json`` files the
reference consumes (src/slam.cpp:1045-1061 via
serialization.h:125-141): ``value0.cam.T_i_c`` is a list of SE3 poses as
{px..qw} dicts and ``value0.cam.intrinsics`` a list of
{cam_type, fx, fy, cx, cy, p1..p4, width, height} dicts.

Host copy of ``vslam_tpu/io/calib.py`` for the PyTorch port.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

import numpy as np


@dataclasses.dataclass
class Calibration:
    """Stereo rig calibration. Pose layout [tx,ty,tz,qx,qy,qz,qw]."""

    T_i_c: np.ndarray        # [num_cams, 7] camera-to-IMU extrinsics
    intrinsics: np.ndarray   # [num_cams, 8] fx fy cx cy p1 p2 p3 p4
    cam_types: List[str]     # e.g. ["ds", "ds"]
    width: int
    height: int

    @property
    def num_cams(self) -> int:
        return self.T_i_c.shape[0]


def _pose_from_dict(d) -> np.ndarray:
    return np.array(
        [d["px"], d["py"], d["pz"], d["qx"], d["qy"], d["qz"], d["qw"]],
        dtype=np.float64,
    )


def _pose_to_dict(p) -> dict:
    keys = ["px", "py", "pz", "qx", "qy", "qz", "qw"]
    return {k: float(v) for k, v in zip(keys, p)}


def load_calibration(path: str) -> Calibration:
    with open(path) as f:
        data = json.load(f)
    cam = data["value0"]
    T_i_c = np.stack([_pose_from_dict(d) for d in cam["cam.T_i_c"]])
    intr, types = [], []
    width = height = 0
    for d in cam["cam.intrinsics"]:
        types.append(d["cam_type"])
        intr.append([d["fx"], d["fy"], d["cx"], d["cy"],
                     d["p1"], d["p2"], d["p3"], d["p4"]])
        width, height = int(d["width"]), int(d["height"])
    return Calibration(
        T_i_c=T_i_c, intrinsics=np.asarray(intr, dtype=np.float64),
        cam_types=types, width=width, height=height,
    )


def save_calibration(calib: Calibration, path: str) -> None:
    cams = []
    for i in range(calib.num_cams):
        fx, fy, cx, cy, p1, p2, p3, p4 = calib.intrinsics[i]
        cams.append({
            "cam_type": calib.cam_types[i],
            "fx": fx, "fy": fy, "cx": cx, "cy": cy,
            "p1": p1, "p2": p2, "p3": p3, "p4": p4,
            "width": calib.width, "height": calib.height,
        })
    data = {"value0": {
        "cam.T_i_c": [_pose_to_dict(calib.T_i_c[i]) for i in range(calib.num_cams)],
        "cam.intrinsics": cams,
    }}
    with open(path, "w") as f:
        json.dump(data, f, indent=4)
