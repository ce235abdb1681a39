"""EuRoC MAV dataset loading.

Port of ``vslam_tpu/io/euroc.py`` (host code; the dataset readers and the
prefetcher are copies, but a decode error in a prefetch thread is raised
by ``get``). Mirrors the reference's loader semantics
(slam.cpp:1006-1079 and include/io/dataset_io_euroc.h:42-134):
cam0/data.csv provides timestamps + image file names for both cams; ground
truth comes from ``state_groundtruth_estimate0/data.csv`` (preferred) or
``gt/data.csv``. The flat sample layout (``<timestamp>_<cam>.jpg``) loads
too.

Image decoding: binary PGM (``P5``, 8-bit) is decoded here with numpy, so
a dataset of ``.pgm`` files needs no imaging library; every other format
goes through the native C++ decoder (``io/native.py``) where its library
loads, else through PIL, and a missing PIL raises (a frame is never
blank). A background prefetch thread keeps decode off the critical path.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from . import native


@dataclasses.dataclass
class EurocSequence:
    timestamps: np.ndarray          # [F] int64 ns
    image_paths: List[Tuple[str, str]]  # [(left, right)] per frame
    gt_timestamps: Optional[np.ndarray] = None  # [G] int64
    gt_positions: Optional[np.ndarray] = None   # [G, 3]
    gt_quats: Optional[np.ndarray] = None       # [G, 4] xyzw

    @property
    def num_frames(self) -> int:
        return len(self.image_paths)


def _read_timestamp_csv(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            rows.append((int(parts[0]), parts[1].strip()))
    return rows


def _read_gt_csv(path: str):
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split(",")
            ts.append(int(p[0]))
            pos.append([float(p[1]), float(p[2]), float(p[3])])
            # EuRoC order: qw qx qy qz -> store xyzw
            quat.append([float(p[5]), float(p[6]), float(p[7]), float(p[4])])
    return (np.asarray(ts, np.int64), np.asarray(pos, np.float64),
            np.asarray(quat, np.float64))


def load_sequence(dataset_path: str) -> EurocSequence:
    """Load a standard EuRoC directory (mav0-style layout)."""
    ts_csv = os.path.join(dataset_path, "cam0", "data.csv")
    if os.path.exists(ts_csv):
        rows = _read_timestamp_csv(ts_csv)
        timestamps = np.asarray([r[0] for r in rows], dtype=np.int64)
        image_paths = [
            (os.path.join(dataset_path, "cam0", "data", name),
             os.path.join(dataset_path, "cam1", "data", name))
            for _, name in rows
        ]
    else:
        return load_sample_dir(dataset_path)

    seq = EurocSequence(timestamps=timestamps, image_paths=image_paths)
    for gt_dir in ("state_groundtruth_estimate0", "gt"):
        gt_csv = os.path.join(dataset_path, gt_dir, "data.csv")
        if os.path.exists(gt_csv):
            seq.gt_timestamps, seq.gt_positions, seq.gt_quats = _read_gt_csv(gt_csv)
            break
    return seq


def load_sample_dir(path: str) -> EurocSequence:
    """Load the bundled flat sample layout: <timestamp>_<cam>.jpg pairs."""
    frames = {}
    for name in os.listdir(path):
        if not name.endswith(".jpg"):
            continue
        stem = name[:-4]
        ts_str, cam = stem.rsplit("_", 1)
        frames.setdefault(int(ts_str), {})[int(cam)] = os.path.join(path, name)
    ts_sorted = sorted(t for t, cams in frames.items() if 0 in cams and 1 in cams)
    return EurocSequence(
        timestamps=np.asarray(ts_sorted, dtype=np.int64),
        image_paths=[(frames[t][0], frames[t][1]) for t in ts_sorted],
    )


# ---------------------------------------------------------------------------
# Image decoding (binary PGM with numpy, everything else through the
# native C++ decoder when it loads, else PIL)
# ---------------------------------------------------------------------------

def _decode_pil(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: decoding anything but binary PGM (P5) needs Pillow, "
            "which is not installed") from e

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.uint8)


def _decode_pgm(data: bytes, path: str) -> np.ndarray:
    """Binary PGM (P5, maxval < 256) -> uint8 [H, W]. The header is four
    whitespace-separated tokens (magic, width, height, maxval) with
    optional ``#`` comments, then one whitespace byte, then the raster."""
    tokens, pos = [], 2
    while len(tokens) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        tokens.append(int(data[pos:end]))
        pos = end
    width, height, maxval = tokens
    if not 0 < maxval < 256:
        raise ValueError(f"{path}: PGM maxval {maxval} is not 8-bit")
    pos += 1  # the single whitespace byte that ends the header
    raster = np.frombuffer(data, np.uint8, count=width * height, offset=pos)
    return raster.reshape(height, width).copy()


def load_image(path: str) -> np.ndarray:
    """Decode one grayscale image to uint8 [H, W]."""
    with open(path, "rb") as f:
        magic = f.read(2)
        if magic == b"P5":
            return _decode_pgm(magic + f.read(), path)
    img = native.decode_gray(path)   # None: no library, or not a JPEG
    return img if img is not None else _decode_pil(path)


def save_pgm(path: str, img) -> None:
    """Write uint8 [H, W] as binary PGM."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


class Prefetcher:
    """Background stereo-pair decoder: keeps IO off the tracking hot path.

    The analogue of the reference overlapping image loads with compute
    via threads; here a small thread pool decodes ahead of the frame
    loop.
    """

    def __init__(self, image_paths, depth: int = 8, workers: int = 2):
        self._paths = image_paths
        self._depth = depth
        self._next_submit = 0
        self._consumed = 0
        self._results = {}
        self._cv = threading.Condition()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            with self._cv:
                while (self._next_submit - self._consumed) >= self._depth:
                    self._cv.wait(timeout=1.0)
                i = self._next_submit
                if i >= len(self._paths):
                    return
                self._next_submit += 1
            left, right = self._paths[i]
            try:
                pair = (load_image(left), load_image(right))
            except Exception as e:   # handed to the consumer, see get()
                pair = e
            with self._cv:
                self._results[i] = pair
                self._cv.notify_all()

    def get(self, i: int):
        with self._cv:
            while i not in self._results:
                self._cv.wait(timeout=10.0)
            self._consumed = max(self._consumed, i)
            self._cv.notify_all()
            pair = self._results.pop(i)
        if isinstance(pair, Exception):
            raise pair   # a frame that failed to decode fails the run
        return pair
