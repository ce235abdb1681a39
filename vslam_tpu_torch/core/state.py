"""Fixed-capacity SLAM state as dataclasses of tensors.

Port of ``vslam_tpu/core/state.py``: the same fields, shapes, dtypes and
fill values (-1 for empty slots, packed descriptors ``desc [K, 2, N, 32]
uint8``), so the interop converters (``vslam_tpu_torch/interop.py``) carry
state across field by field. Unlike the reference's immutable pytrees the
port's pipeline functions may update these tensors in place; a function
that does so says so in its docstring.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie


class TensorState:
    """Helpers shared by the state dataclasses."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def map_tensors(obj, fn):
    """``fn`` over a tensor, or over every tensor of a dataclass (nested
    ones too); fields that hold anything else (None, host integers) stay
    as they are."""
    if torch.is_tensor(obj):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


@dataclasses.dataclass
class LandmarkState(TensorState):
    pos: torch.Tensor         # [L, 3] world position (lm.p)
    pos_c: torch.Tensor       # [L, 3] anchor-frame position (lm.p_c)
    from_kf: torch.Tensor     # [L] int32 anchor KF slot (lm.from_fcid)
    valid: torch.Tensor       # [L] bool allocated
    active: torch.Tensor      # [L] bool has windowed obs (lm.active)
    # windowed observations (lm.obs): row-padded tables
    obs_kf: torch.Tensor      # [L, M] int32 KF slot, -1 empty
    obs_cam: torch.Tensor     # [L, M] int32 0/1
    obs_feat: torch.Tensor    # [L, M] int32 feature index
    # lifetime observations (lm.all_obs)
    all_kf: torch.Tensor      # [L, M2] int32
    all_cam: torch.Tensor     # [L, M2] int32
    all_feat: torch.Tensor    # [L, M2] int32
    # descriptor bank (stand-in for min over all_obs descriptors)
    bank_bits: torch.Tensor   # [L, B, 256] uint8
    bank_valid: torch.Tensor  # [L, B] bool
    bank_next: torch.Tensor   # [L] int32 round-robin cursor
    next_slot: torch.Tensor   # [] int32 allocation cursor


@dataclasses.dataclass
class KeyframeState(TensorState):
    frame_id: torch.Tensor    # [K] int32, -1 empty
    pose_l: torch.Tensor      # [K, 7] T_w_c cam0
    pose_r: torch.Tensor      # [K, 7] T_w_c cam1
    valid: torch.Tensor       # [K] bool
    active: torch.Tensor      # [K] bool (in BA window)
    parent: torch.Tensor      # [K] int32 spanning-tree parent slot
    corners: torch.Tensor     # [K, 2, N, 2] float32
    desc: torch.Tensor        # [K, 2, N, 32] uint8 packed bits
    kp_valid: torch.Tensor    # [K, 2, N] bool
    map_points: torch.Tensor  # [K, N] int32 landmark id per left feature
    next_slot: torch.Tensor   # [] int32


@dataclasses.dataclass
class TrackState(TensorState):
    current_pose: torch.Tensor  # [7] T_w_c (left cam)
    last_pose: torch.Tensor     # [7]
    vel: torch.Tensor           # [7] constant-velocity model
    tracking_ok: torch.Tensor   # [] bool


def init_landmarks(L: int, M: int = 24, M2: int = 48, B: int = 4,
                   dtype=torch.float32, device=None) -> LandmarkState:
    i32 = dict(dtype=torch.int32, device=device)
    return LandmarkState(
        pos=torch.zeros((L, 3), dtype=dtype, device=device),
        pos_c=torch.zeros((L, 3), dtype=dtype, device=device),
        from_kf=torch.full((L,), -1, **i32),
        valid=torch.zeros((L,), dtype=torch.bool, device=device),
        active=torch.zeros((L,), dtype=torch.bool, device=device),
        obs_kf=torch.full((L, M), -1, **i32),
        obs_cam=torch.zeros((L, M), **i32),
        obs_feat=torch.zeros((L, M), **i32),
        all_kf=torch.full((L, M2), -1, **i32),
        all_cam=torch.zeros((L, M2), **i32),
        all_feat=torch.zeros((L, M2), **i32),
        bank_bits=torch.zeros((L, B, 256), dtype=torch.uint8, device=device),
        bank_valid=torch.zeros((L, B), dtype=torch.bool, device=device),
        bank_next=torch.zeros((L,), **i32),
        next_slot=torch.zeros((), **i32),
    )


def init_keyframes(K: int, N: int, dtype=torch.float32,
                   device=None) -> KeyframeState:
    i32 = dict(dtype=torch.int32, device=device)
    ident = lie.identity_pose(dtype, device)
    return KeyframeState(
        frame_id=torch.full((K,), -1, **i32),
        pose_l=ident.repeat(K, 1),
        pose_r=ident.repeat(K, 1),
        valid=torch.zeros((K,), dtype=torch.bool, device=device),
        active=torch.zeros((K,), dtype=torch.bool, device=device),
        parent=torch.full((K,), -1, **i32),
        corners=torch.full((K, 2, N, 2), -1.0, dtype=dtype, device=device),
        desc=torch.zeros((K, 2, N, 32), dtype=torch.uint8, device=device),
        kp_valid=torch.zeros((K, 2, N), dtype=torch.bool, device=device),
        map_points=torch.full((K, N), -1, **i32),
        next_slot=torch.zeros((), **i32),
    )


def init_track(dtype=torch.float32, device=None) -> TrackState:
    return TrackState(
        current_pose=lie.identity_pose(dtype, device),
        last_pose=lie.identity_pose(dtype, device),
        vel=lie.identity_pose(dtype, device),
        tracking_ok=torch.zeros((), dtype=torch.bool, device=device),
    )
