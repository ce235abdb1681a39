"""vslam_tpu_torch — the PyTorch + CUDA port of vslam_tpu.

The JAX package ``vslam_tpu`` stays the reference; this package mirrors
its layout and function names (``vslam_tpu_torch/pipeline/tracking.py``
is the port of ``vslam_tpu/pipeline/tracking.py``) and imports neither
JAX nor ``vslam_tpu``. Plain tensor code is PyTorch; the two Pallas
kernels of the reference (guided landmark matching and descriptor
top-2, ``vslam_tpu/ops/pallas_hamming.py``) are hand-written CUDA
kernels for Hopper (``csrc/hamming_top2.cu``, bound in
``ops/cuda_hamming.py``).

State is dataclasses of tensors with the reference's shapes, dtypes and
fill values; every constructor and driver takes an explicit ``device``.
"""

__version__ = "0.1.0"

import torch as _torch

# Pose math (DLT, normal equations, Schur solves) needs true f32 products,
# as vslam_tpu/__init__.py pins jax_default_matmul_precision="highest":
# TF32 keeps ~10 mantissa bits and would corrupt pose solves on the card.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(name: str = "cuda") -> _torch.device:
    """``torch.device`` for ``name``; raises if a CUDA device is asked for
    and none is present (no silent fallback to the CPU)."""
    dev = _torch.device(name)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available")
    return dev
