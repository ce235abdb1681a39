"""Build, load and launch the Hamming top-2 CUDA kernels.

``csrc/hamming_top2.cu`` (with ``csrc/stamp.cu``, the driver's stage
stamps, launched from ``ops/cuda_stamp.py``) is compiled at first use with
``nvcc`` for ``sm_90a`` into ``build/vslam_tpu_torch/libhamming.so``
(beside the repository's packages), a shared library with a plain C
interface that is loaded with ``ctypes``. The build is keyed on a hash of
the sources and the flags, so an edited source rebuilds and an unchanged
one loads at once. ``LOADED`` holds the host clock (``perf_counter_ns``)
at the start and end of the first load, the build included.

Both launchers hand the {0,1} descriptor bytes the main path holds to
their kernel, which reads them with 16-byte loads (the descriptor top-2
packs them to bits as it stages them; the landmark top-2 XORs the bytes
as they are, and reads (x, y) pairs with 8-byte loads): a strided input
is copied, and a contiguous one off that alignment raises. Each
launcher checks its inputs, allocates the outputs, makes one launch on
PyTorch's current stream, raises if the launch was refused, and adds one
to its entry of ``LAUNCHES``. The plain PyTorch versions of the same
functions are ``ops/hamming.py``'s ``landmark_top2_plain`` and
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
import time
from pathlib import Path

import torch

from .hamming import gate_radius_sq

LAUNCHES = {"landmark_top2": 0, "hamming_top2": 0}
LOADED = None   # (start, end) ns of the library's first load

SOURCES = tuple(Path(__file__).resolve().parents[1] / "csrc" / name
                for name in ("hamming_top2.cu", "stamp.cu"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vslam_tpu_torch"
LIBRARY = BUILD_DIR / "libhamming.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_BANK = 8  # kMaxBank in the source
# both kernels' merge key holds the candidate index in 23 bits (kArgBits)
MAX_CANDIDATES = 1 << 23
MAX_SEQUENCES = 65535  # kMaxSequences: the grid's y axis

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _build_key() -> str:
    h = hashlib.sha256()
    for source in SOURCES:
        h.update(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels unless a build of these exact sources and these
    flags exists. Returns the library path."""
    key = _build_key()
    stamp = LIBRARY.with_suffix(".so.sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == key:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    stamp.write_text(key)
    return LIBRARY


def _load():
    global _lib, LOADED
    with _lock:
        if _lib is None:
            t0 = time.perf_counter_ns()
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.vslam_hamming_top2.argtypes = [vp, vp, vp, vp, ci, ci,
                                               vp, vp, vp, vp]
            lib.vslam_hamming_top2.restype = ci
            lib.vslam_landmark_top2.argtypes = [vp] * 7 + [
                ctypes.c_float, ci, ci, ci, ci] + [vp] * 5
            lib.vslam_landmark_top2.restype = ci
            lib.vslam_stamp.argtypes = [vp, vp, ci, ci, ci, vp]
            lib.vslam_stamp.restype = ci
            lib.vslam_count.argtypes = [vp, vp, ctypes.c_longlong, vp, ci,
                                        ci, ci, vp]
            lib.vslam_count.restype = ci
            lib.vslam_mapped_pointer.argtypes = [vp,
                                                 ctypes.POINTER(vp)]
            lib.vslam_mapped_pointer.restype = ci
            _lib = lib
            LOADED = (t0, time.perf_counter_ns())
    return _lib


def _check(t, name, dtype, shape, device, align=1):
    """Checks device, dtype and shape and returns ``t`` contiguous (a
    strided ``t`` is copied). The kernel reads the result with
    ``align``-byte loads, so a contiguous, nonempty ``t`` that is not
    ``align``-byte aligned raises.
    """
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    t = t.contiguous()
    if t.numel() and t.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned; the kernel "
                         f"reads it with {align}-byte loads")
    return t


def _cuda_device(t, kernel: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {t.device}")
    return t.device


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def hamming_top2(bits_a, bits_b, valid_a, valid_b):
    """Kernel version of ``hamming.hamming_top2_plain`` (CUDA tensors).

    bits_* [N/M, 256] uint8 {0,1} (16-byte aligned where contiguous),
    valid_* [N/M] bool. Returns (best, second, arg) int32 [N].
    """
    dev = _cuda_device(bits_a, "hamming_top2")
    n, m = bits_a.shape[0], bits_b.shape[0]
    if m > MAX_CANDIDATES:
        raise ValueError(f"{m} candidates; the kernel takes at most "
                         f"{MAX_CANDIDATES}")
    a = _check(bits_a, "bits_a", torch.uint8, (n, 256), dev, align=16)
    b = _check(bits_b, "bits_b", torch.uint8, (m, 256), dev, align=16)
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

    kp_bits [N, 256] uint8 {0,1}, kp_valid [N] bool, kp_xy [N, 2] f32;
    bank_bits [P, B, 256] uint8 {0,1} (B <= 8), bank_valid [P, B] bool,
    lm_proj_xy [P, 2] f32, lm_valid [P] bool; max_dist_2d a number. Or
    every tensor with the same leading sequence axis [S, ...]: S stacked
    problems in one launch (the kernel's grid y axis), ``arg`` an index
    into the sequence's own P. Where contiguous, the descriptor bytes must
    be 16-byte and the xy 8-byte aligned (every sequence's slab then is).
    Returns (best, second, arg) int32 [N] and any_candidate bool [N], or
    [S, N] each. One launch, and one count, per call whatever S is.
    """
    batched = kp_bits.dim() == 3
    ranks = (2, 1, 2, 3, 2, 2, 1)
    tensors = (kp_bits, kp_valid, kp_xy, bank_bits, bank_valid, lm_proj_xy,
               lm_valid)
    if any(t.dim() != r + batched for t, r in zip(tensors, ranks)):
        raise ValueError(
            "landmark_top2 takes every tensor with a leading sequence axis "
            f"or none with one; got ranks {[t.dim() for t in tensors]}")
    dev = _cuda_device(kp_bits, "landmark_top2")
    lead = (kp_bits.shape[0],) if batched else ()
    n = kp_bits.shape[-2]
    p, nb = bank_bits.shape[-3], bank_bits.shape[-2]
    if nb > MAX_BANK:
        raise ValueError(f"landmark bank of {nb} slots; the kernel takes at "
                         f"most {MAX_BANK}")
    if p > MAX_CANDIDATES:
        raise ValueError(f"{p} landmarks; the kernel takes at most "
                         f"{MAX_CANDIDATES}")
    if batched and lead[0] > MAX_SEQUENCES:
        raise ValueError(f"{lead[0]} sequences; the kernel takes at most "
                         f"{MAX_SEQUENCES}")
    kp = _check(kp_bits, "kp_bits", torch.uint8, lead + (n, 256), dev,
                align=16)
    bank = _check(bank_bits, "bank_bits", torch.uint8, lead + (p, nb, 256),
                  dev, align=16)
    kv = _check(kp_valid, "kp_valid", torch.bool, lead + (n,), dev)
    kxy = _check(kp_xy, "kp_xy", torch.float32, lead + (n, 2), dev, align=8)
    bv = _check(bank_valid, "bank_valid", torch.bool, lead + (p, nb), dev)
    lxy = _check(lm_proj_xy, "lm_proj_xy", torch.float32, lead + (p, 2), dev,
                 align=8)
    lv = _check(lm_valid, "lm_valid", torch.bool, lead + (p,), dev)
    best = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    second = torch.empty_like(best)
    arg = torch.empty_like(best)
    any_c = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    if best.numel():
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vslam_landmark_top2(
                kp.data_ptr(), kv.data_ptr(), kxy.data_ptr(),
                bank.data_ptr(), bv.data_ptr(), lxy.data_ptr(),
                lv.data_ptr(), gate_radius_sq(max_dist_2d),
                lead[0] if batched else 1, n, p, nb, best.data_ptr(),
                second.data_ptr(), arg.data_ptr(), any_c.data_ptr(), stream)
        _raise_on(err, "landmark_top2")
        LAUNCHES["landmark_top2"] += 1
    return best, second, arg, any_c
