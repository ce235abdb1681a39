"""Device mesh helpers for scaling over several devices.

Port of ``vslam_tpu/parallel/mesh.py``. The reference's mesh is a
``jax.sharding.Mesh`` and XLA inserts the communication; the port's mesh is
an ordered array of ``torch.device``s with named axes, and the code that
uses it writes the communication out (``solvers/ba_cg.py`` sums per-shard
partial results on the lead device; ``parallel/multiseq_runner.py`` selects
its per-sequence keyframe branch by it). Like the reference the port is
single-controller: one process drives every device of the mesh, with no
``torch.distributed`` process group.

A device may appear more than once (``devices=["cuda:0", "cuda:0"]``, or
several entries of the CPU): the shards then share that device, which is
how a sharded solve is exercised where there is one card or none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: np.ndarray            # object array of torch.device, one axis
    #                                per name
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "data") -> list:
        """The devices along ``axis`` (at index 0 of every other axis)."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])


def available_devices() -> list:
    """Every card of the process, or the CPU where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([torch.device("cuda", i) for i in range(n)]
            or [torch.device("cpu")])


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """The first ``n_devices`` of ``devices`` (default: every device of the
    process) as a mesh. One axis: shape (n,). Two axes: a wide data axis,
    the second axis gets 2 when n is even and at least 4, else 1."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else available_devices())]
    n = n_devices or len(devs)
    devs = devs[:n]
    n = len(devs)
    if len(axes) == 1:
        shape = (n,)
    elif len(axes) == 2:
        model = 2 if n % 2 == 0 and n >= 4 else 1
        shape = (n // model, model)
    else:
        raise ValueError(f"unsupported axes {axes}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axes))
