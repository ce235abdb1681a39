"""Launch the stage-stamp kernels of ``csrc/stamp.cu``.

The kernels are built into the Hamming kernels' library
(``ops/cuda_hamming.py``). Each launcher makes one one-thread launch on
PyTorch's current stream and raises if the launch was refused; none of
them counts in ``cuda_hamming.LAUNCHES``. ``utils/profiling.SpanRecorder``
is their caller: its ring is pinned host memory, and a launcher takes the
ring's device address (``mapped_pointer``).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_hamming


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def mapped_pointer(host: torch.Tensor) -> int:
    """The device address of a pinned host tensor."""
    if not host.is_pinned():
        raise ValueError("the stamp ring must be pinned host memory")
    out = ctypes.c_void_p()
    _raise_on(cuda_hamming._load().vslam_mapped_pointer(
        host.data_ptr(), ctypes.byref(out)), "cudaHostGetDevicePointer")
    return out.value


def stamp(frame, ring: int, rows: int, cols: int, col: int):
    """Write the device's nanosecond timer into slot [frame mod rows, col]
    of the ring at device address ``ring``; ``frame`` is a 0-dim int32
    CUDA tensor, or None for slot [0, col]."""
    _raise_on(cuda_hamming._load().vslam_stamp(
        None if frame is None else frame.data_ptr(), ring, rows, cols, col,
        _stream()), "stamp launch")


def count(frame, value, ring: int, rows: int, cols: int, col: int):
    """Write ``value`` (a 0-dim int32 CUDA tensor, or an int) into slot
    [frame mod rows, col]."""
    if torch.is_tensor(value):
        if value.dtype != torch.int32 or value.device.type != "cuda":
            raise ValueError(f"a counted value must be a CUDA int32 tensor, "
                             f"got {value.dtype} on {value.device}")
        ptr, constant = value.data_ptr(), 0
    else:
        ptr, constant = None, int(value)
    _raise_on(cuda_hamming._load().vslam_count(
        frame.data_ptr(), ptr, constant, ring, rows, cols, col, _stream()),
        "count launch")
