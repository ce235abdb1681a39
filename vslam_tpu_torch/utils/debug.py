"""Debug guards: finite-state assertions.

Port of ``vslam_tpu/utils/debug.py``: assert that every float tensor of
the SLAM state is finite after each frame (``config.debug_checks``). One
device reduction and one host read per tensor: debug only.
"""

from __future__ import annotations

import dataclasses

import torch


def find_nonfinite(tree) -> dict:
    """Names of the float tensors of a state dataclass that contain
    non-finite values. Returns {field: count}."""
    bad = {}
    for f in dataclasses.fields(tree):
        val = getattr(tree, f.name)
        if not torch.is_tensor(val) or not val.is_floating_point():
            continue
        n = int(torch.sum(~torch.isfinite(val)))
        if n:
            bad[f.name] = n
    return bad


def assert_finite_state(slam) -> None:
    """Raise if any pose/landmark tensor went non-finite (debug_checks)."""
    problems = {}
    for label, tree in (("lm", slam.lm), ("kf", slam.kf),
                        ("track", slam.track)):
        for field, count in find_nonfinite(tree).items():
            problems[f"{label}.{field}"] = count
    if problems:
        raise FloatingPointError(
            f"non-finite SLAM state after frame {slam.frame}: {problems}")
