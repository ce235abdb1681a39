"""World kind ``sprite_fleet``: one sprite world per rig, rendered into one
interleaved stream.

A traffic file's ``world`` entry is kind ``sprites``'s, with
``layout_seeds`` (one per rig) in place of ``layout_seed``: rig ``s``'s
billboards stand where ``layout_seeds[s]`` puts them, in a box that
follows that rig's own path; the run's seed deals the textures, rig by
rig. Each stream frame shows its rig's world from its pose there, in the
order of trajectory kind ``fleet`` (``fleet.rig_at``).
"""

import numpy as np

from harness import cells


def render(spec: dict, rig, poses, rng, device):
    """(left, right) uint8 [F, H, W] host images of the interleaved
    stream along ``poses`` [F, 7]."""
    sprites = cells.module("worlds", "sprites")
    fleet = cells.module("trajectories", "fleet")
    seeds = spec["layout_seeds"]
    R = len(seeds)
    if len(poses) % R:
        raise ValueError(f"{len(poses)} stream frames are not a whole "
                         f"number of lockstep frames of {R} rigs")
    base = {k: v for k, v in spec.items() if k != "layout_seeds"}
    left = np.empty((len(poses), rig.height, rig.width), np.uint8)
    right = np.empty_like(left)
    for s, seed in enumerate(seeds):
        idx = fleet.stream_index(s, np.arange(len(poses) // R), R)
        left[idx], right[idx] = sprites.render(
            dict(base, layout_seed=seed), rig, poses[idx], rng, device)
    return left, right
