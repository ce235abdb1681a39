"""ctypes bindings for the native C++ runtime library (native/).

Provides the fast JPEG grayscale decoder and the DBoW2 vocabulary text
parser. Everything degrades gracefully when the library isn't built —
callers fall back to PIL / numpy parsing.

Build with: make -C native
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libvslam_native.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _LIB_PATH
    if not os.path.exists(path):
        # try building it once (toolchain is available in the image)
        try:
            subprocess.run(["make", "-C", os.path.dirname(path)],
                           capture_output=True, timeout=120, check=False)
        except Exception:
            pass
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.vslam_decode_gray.restype = ctypes.c_int
        lib.vslam_decode_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.vslam_vocab_count.restype = ctypes.c_long
        lib.vslam_vocab_count.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.vslam_vocab_parse.restype = ctypes.c_int
        lib.vslam_vocab_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


_MAX_BYTES = 4096 * 3072


def decode_gray(path: str) -> Optional[np.ndarray]:
    """Decode a JPEG to uint8 [H, W]; None if unsupported/not built."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(_MAX_BYTES, dtype=np.uint8)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.vslam_decode_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        _MAX_BYTES, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def parse_vocab_text(path: str):
    """Parse DBoW2 text vocab. Returns (k, depth, parents, is_leaf, descs,
    weights) or None."""
    lib = _load()
    if lib is None:
        return None
    k = ctypes.c_int(0)
    depth = ctypes.c_int(0)
    n = lib.vslam_vocab_count(path.encode(), ctypes.byref(k),
                              ctypes.byref(depth))
    if n <= 0:
        return None
    parents = np.empty(n, np.int32)
    is_leaf = np.empty(n, np.uint8)
    descs = np.empty((n, 32), np.uint8)
    weights = np.empty(n, np.float64)
    rc = lib.vslam_vocab_parse(
        path.encode(), n,
        parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        is_leaf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        descs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    return int(k.value), int(depth.value), parents, is_leaf.astype(bool), \
        descs, weights
