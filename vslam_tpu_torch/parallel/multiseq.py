"""Batched multi-sequence tracking: data parallelism over sequences.

Port of ``vslam_tpu/parallel/multiseq.py``. The reference vmaps its
per-frame tracking step over a sequence axis and shards that axis over a
mesh; the port's ``tracking.track_frame`` takes the sequence axis itself
(one batched call, one launch of the landmark top-2 kernel for all
sequences), and this constructor places the sequences by the mesh's list
of devices: neighbouring entries of the same device are one batched call
on that device, and the results come back, stacked, on the first device.
On one card (or the CPU) that is a single call.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.state import LandmarkState, map_tensors
from ..pipeline import tracking
from .mesh import Mesh


def _stack_results(parts):
    """Per-group results (dataclasses of [s_g, ...] tensors, on one device)
    concatenated along the sequence axis."""
    first = parts[0]
    if torch.is_tensor(first):
        return torch.cat(parts)
    return dataclasses.replace(first, **{
        f.name: _stack_results([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(first)
        if getattr(first, f.name) is not None})


def batched_track_frame(mesh: Mesh, cam_name: str, **static_kwargs):
    """Build the multi-sequence tracking step over ``mesh``.

    Returns fn(imgs [S,H,W], lm (LandmarkState leading with S), predicted
    [S,7], gate [S,7], vel [S,7], intr0 [S,8] (one row per sequence) or
    [8] (shared), generator=None, sample_idx=None) -> TrackResult leading
    with S, on the mesh's first device. S must be a multiple of the 'data'
    axis; sequence block i goes to device i. ``generator`` must live on
    the device that uses it, so a mesh of several different devices takes
    the RANSAC draws as ``sample_idx`` [S, H, 6].
    """
    step = functools.partial(tracking.track_frame, cam_name=cam_name,
                             **static_kwargs)
    devs = mesh.axis_devices("data")

    def run(imgs, lm: LandmarkState, predicted, gate, vel, intr0,
            generator=None, sample_idx=None):
        S = imgs.shape[0]
        if S % len(devs):
            raise ValueError(f"{S} sequences do not divide over the mesh's "
                             f"{len(devs)} devices")
        per = S // len(devs)
        # neighbouring entries of one device form one batched call
        groups = []
        for i, d in enumerate(devs):
            if groups and groups[-1][0] == d:
                groups[-1][2] = (i + 1) * per
            else:
                groups.append([d, i * per, (i + 1) * per])
        home = devs[0]
        parts = []
        for d, lo, hi in groups:
            if generator is not None and sample_idx is None \
                    and generator.device != d:
                raise ValueError(
                    f"the generator lives on {generator.device}, the "
                    f"sequences {lo}..{hi - 1} on {d}: pass sample_idx")

            def put(x, d=d, lo=lo, hi=hi):
                return x[lo:hi].to(d)

            res = step(put(imgs), map_tensors(lm, put), put(predicted),
                       put(gate), put(vel),
                       (intr0 if intr0.dim() == 1 else intr0[lo:hi]).to(d),
                       generator=generator,
                       sample_idx=None if sample_idx is None
                       else put(sample_idx))
            parts.append(map_tensors(res, lambda x: x.to(home)))
        return parts[0] if len(parts) == 1 else _stack_results(parts)

    return run
