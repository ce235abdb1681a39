"""Conditional IF nodes in a CUDA graph being captured (``csrc/graph_if.cu``).

``if_node(pred)`` captures the work of its ``with`` block into an IF node
of the graph that PyTorch's current stream is capturing: at replay the
block runs only where ``pred`` (a 0-dim bool on the card) holds when the
node is reached, and is skipped by the device otherwise, with no host read
and no launch of its own. The node is made through the CUDA runtime
(``cudaGraphConditionalHandleCreate``, a conditional node added to the
capturing graph, ``cudaStreamBeginCaptureToGraph`` into its body), since
PyTorch 2.11 has no binding for it. The library is the Hamming kernels'
(``ops/cuda_hamming.py``).

The block is captured on ``side_stream(device)``, a stream of the
library's own, one per device. The caching allocator places what the
block allocates in a scratch pool, one per device, that nothing else
allocates from. Blocks of that pool are reused from one IF body to the
next, in this graph and in any other, so everything allocated inside a
body must be dead at its end: a body writes its results into tensors
allocated before it. Graphs with IF bodies are therefore replayed one at
a time, as the drivers replay their bodies.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import cuda_hamming
from .cuda_stamp import _raise_on

_streams = {}   # device index -> torch.cuda.ExternalStream
_pools = {}     # device index -> the scratch pool's mempool id


def side_stream(device) -> torch.cuda.ExternalStream:
    """The device's stream of the library's own (created at first use and
    kept for the process): IF bodies are captured on it, and the drivers
    run their bodies' warm-ups on it."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _streams:
        raw = ctypes.c_void_p()
        with torch.cuda.device(index):
            _raise_on(cuda_hamming._load().vslam_stream_create(
                ctypes.byref(raw)), "cudaStreamCreateWithFlags")
        _streams[index] = torch.cuda.ExternalStream(raw.value,
                                                    device=index)
    return _streams[index]


def _scratch_pool(index: int):
    if index not in _pools:
        _pools[index] = torch.cuda.graph_pool_handle()
    return _pools[index]


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the block into an IF node on ``pred`` (module docstring).
    Only inside a CUDA-graph capture on ``pred``'s device."""
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.dim():
        raise ValueError(f"an IF node's predicate is a 0-dim bool CUDA "
                         f"tensor, got {pred.dtype} {tuple(pred.shape)} on "
                         f"{pred.device}")
    lib = cuda_hamming._load()
    body = side_stream(pred.device)
    index = body.device.index
    pool = _scratch_pool(index)
    outer = torch.cuda.current_stream(pred.device)
    _raise_on(lib.vslam_if_begin(outer.cuda_stream, pred.data_ptr(),
                                 body.cuda_stream), "opening an IF node")
    try:
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(index, pool)
    finally:
        _raise_on(lib.vslam_if_end(body.cuda_stream),
                  "ending an IF node's body")
