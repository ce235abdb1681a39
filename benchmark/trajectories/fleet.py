"""Trajectory kind ``fleet``: several rigs' paths, interleaved into one
stream.

A traffic file's ``trajectory`` entry: ``speeds`` (one forward speed in
metres a frame per rig) and the ``sway`` and ``yaw`` of kind ``path``,
which every rig follows. Rig ``s`` is kind ``path`` with ``velocity``
(0, 0, ``speeds[s]``), so every rig starts at the identity pose and the
rigs drift apart along the corridor.

A lockstep frame is R consecutive stream frames (R rigs), one per rig, in
an order that turns by one rig a lockstep frame: stream frame ``R t + j``
is rig ``(t + j + 1) mod R``'s frame ``t`` (``rig_at``), so the last
stream frame of lockstep frame ``t``, the one a call's newest answers
belong to, is rig ``t mod R``'s, and every rig is last once in R lockstep
frames. Consecutive stream frames are rigs ``s`` and ``s + 1`` (mod R),
so the stream's frame-to-frame pose differences compare neighbouring
rigs' poses at one lockstep frame.
"""

import numpy as np

from harness import cells


def rig_at(f, R: int):
    """(rig, lockstep frame) of stream frame(s) ``f``."""
    t, j = np.divmod(f, R)
    return (t + j + 1) % R, t


def stream_index(s, t, R: int):
    """The stream frame(s) of rig ``s``'s lockstep frame(s) ``t``."""
    return R * np.asarray(t) + (s - np.asarray(t) - 1) % R


def rig_paths(spec: dict, frames_per_rig: int) -> list:
    """Each rig's [frames_per_rig, 7] poses T_w_c."""
    path = cells.module("trajectories", "path")
    return [path.poses(dict(velocity=[0.0, 0.0, v],
                            sway=spec.get("sway", []),
                            yaw=spec.get("yaw", [])), frames_per_rig)
            for v in spec["speeds"]]


def poses(spec: dict, num_frames: int) -> np.ndarray:
    """[num_frames, 7] poses of the interleaved stream; ``num_frames`` is
    a whole number of lockstep frames."""
    R = len(spec["speeds"])
    if num_frames % R:
        raise ValueError(f"{num_frames} stream frames are not a whole "
                         f"number of lockstep frames of {R} rigs")
    T = num_frames // R
    out = np.empty((num_frames, 7))
    for s, p in enumerate(rig_paths(spec, T)):
        out[stream_index(s, np.arange(T), R)] = p
    return out
