"""Build, load and launch the Hamming top-2 CUDA kernels.

``csrc/hamming_top2.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into ``build/vslam_tpu_torch/libhamming.so`` (beside the
repository's packages), a shared library with a plain C interface that is
loaded with ``ctypes``. The build is keyed on a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.

Each wrapper packs the descriptor bits into the kernel's 32-byte layout
(``describe.pack_bits``) and calls the ``*_packed`` launcher, which checks
its inputs, allocates the outputs, launches on PyTorch's current stream,
raises if the launch was refused, and adds one to its entry of
``LAUNCHES``. The plain PyTorch versions of the same functions
are ``ops/hamming.py``'s ``landmark_top2_plain`` and
``hamming_top2_plain``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from . import describe
from .hamming import gate_radius_sq

LAUNCHES = {"landmark_top2": 0, "hamming_top2": 0}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hamming_top2.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vslam_tpu_torch"
LIBRARY = BUILD_DIR / "libhamming.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_BANK = 8  # kMaxBank in the source

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _build_key() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels unless a build of this exact source and these
    flags exists. Returns the library path."""
    key = _build_key()
    stamp = LIBRARY.with_suffix(".so.sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == key:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    stamp.write_text(key)
    return LIBRARY


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.vslam_hamming_top2.argtypes = [vp, vp, vp, vp, ci, ci,
                                               vp, vp, vp, vp]
            lib.vslam_hamming_top2.restype = ci
            lib.vslam_landmark_top2.argtypes = [vp] * 7 + [
                ctypes.c_float, ci, ci, ci] + [vp] * 5
            lib.vslam_landmark_top2.restype = ci
            _lib = lib
    return _lib


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.contiguous()


def _packed(bits, name, rows, device):
    bits = _check(bits, name, torch.uint8, rows + (256,), device)
    return describe.pack_bits(bits).contiguous()


def _cuda_device(t, kernel: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {t.device}")
    return t.device


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def hamming_top2(bits_a, bits_b, valid_a, valid_b):
    """Kernel version of ``hamming.hamming_top2_plain`` (CUDA tensors).

    bits_* [N/M, 256] uint8 {0,1}, valid_* [N/M] bool. Returns (best,
    second, arg) int32 [N].
    """
    dev = _cuda_device(bits_a, "hamming_top2")
    n, m = bits_a.shape[0], bits_b.shape[0]
    return hamming_top2_packed(_packed(bits_a, "bits_a", (n,), dev),
                               _packed(bits_b, "bits_b", (m,), dev),
                               valid_a, valid_b)


def hamming_top2_packed(a, b, valid_a, valid_b):
    """``hamming_top2`` on descriptors already packed to [N/M, 32] uint8
    (``describe.pack_bits`` layout): the launch itself."""
    dev = _cuda_device(a, "hamming_top2")
    n, m = a.shape[0], b.shape[0]
    a = _check(a, "a", torch.uint8, (n, 32), dev)
    b = _check(b, "b", torch.uint8, (m, 32), dev)
    va = _check(valid_a, "valid_a", torch.bool, (n,), dev)
    vb = _check(valid_b, "valid_b", torch.bool, (m,), dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty_like(best)
    arg = torch.empty_like(best)
    if n:
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vslam_hamming_top2(
                a.data_ptr(), b.data_ptr(), va.data_ptr(), vb.data_ptr(), n,
                m, best.data_ptr(), second.data_ptr(), arg.data_ptr(), stream)
        _raise_on(err, "hamming_top2")
        LAUNCHES["hamming_top2"] += 1
    return best, second, arg


def landmark_top2(kp_bits, kp_valid, kp_xy, bank_bits, bank_valid,
                  lm_proj_xy, lm_valid, max_dist_2d):
    """Kernel version of ``hamming.landmark_top2_plain`` (CUDA tensors).

    kp_bits [N, 256] uint8, kp_valid [N] bool, kp_xy [N, 2] f32; bank_bits
    [P, B, 256] uint8 (B <= 8), bank_valid [P, B] bool, lm_proj_xy [P, 2]
    f32, lm_valid [P] bool; max_dist_2d a number. Returns (best, second,
    arg) int32 [N] and any_candidate bool [N].
    """
    dev = _cuda_device(kp_bits, "landmark_top2")
    n = kp_bits.shape[0]
    p, nb = bank_bits.shape[0], bank_bits.shape[1]
    return landmark_top2_packed(
        _packed(kp_bits, "kp_bits", (n,), dev), kp_valid, kp_xy,
        _packed(bank_bits, "bank_bits", (p, nb), dev), bank_valid,
        lm_proj_xy, lm_valid, max_dist_2d)


def landmark_top2_packed(kp, kp_valid, kp_xy, bank, bank_valid, lm_proj_xy,
                         lm_valid, max_dist_2d):
    """``landmark_top2`` on descriptors already packed (kp [N, 32], bank
    [P, B, 32] uint8): the launch itself."""
    dev = _cuda_device(kp, "landmark_top2")
    n = kp.shape[0]
    p, nb = bank.shape[0], bank.shape[1]
    if nb > MAX_BANK:
        raise ValueError(f"landmark bank of {nb} slots; the kernel takes at "
                         f"most {MAX_BANK}")
    kp = _check(kp, "kp", torch.uint8, (n, 32), dev)
    bank = _check(bank, "bank", torch.uint8, (p, nb, 32), dev)
    kv = _check(kp_valid, "kp_valid", torch.bool, (n,), dev)
    kxy = _check(kp_xy, "kp_xy", torch.float32, (n, 2), dev)
    bv = _check(bank_valid, "bank_valid", torch.bool, (p, nb), dev)
    lxy = _check(lm_proj_xy, "lm_proj_xy", torch.float32, (p, 2), dev)
    lv = _check(lm_valid, "lm_valid", torch.bool, (p,), dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty_like(best)
    arg = torch.empty_like(best)
    any_c = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vslam_landmark_top2(
                kp.data_ptr(), kv.data_ptr(), kxy.data_ptr(),
                bank.data_ptr(), bv.data_ptr(), lxy.data_ptr(),
                lv.data_ptr(), gate_radius_sq(max_dist_2d), n, p, nb,
                best.data_ptr(), second.data_ptr(), arg.data_ptr(),
                any_c.data_ptr(), stream)
        _raise_on(err, "landmark_top2")
        LAUNCHES["landmark_top2"] += 1
    return best, second, arg, any_c
