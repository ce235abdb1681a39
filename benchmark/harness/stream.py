"""The stream of frames a traffic file describes, rendered from the seed.

The traffic file's ``trajectory`` entry names its kind, a file
``benchmark/trajectories/<kind>.py`` with ``poses(spec, num_frames)``;
its ``world`` entry names a kind ``benchmark/worlds/<kind>.py`` with
``render(spec, rig, poses, rng, device)`` returning the (left, right)
host images. ``rendered_frames`` frames are rendered in set-up; with
``replay.cycles`` the stream replays them from ``replay.cycle_start`` on
(a periodic path), else it ends there. The program gets the images from
host memory, as a camera delivers them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import cells


@dataclasses.dataclass
class World:
    rig: Rig
    left: np.ndarray        # [R, H, W] uint8 rendered frames
    right: np.ndarray
    poses: np.ndarray       # [R, 7] ground truth T_w_c (left camera)
    cycle_start: int        # stream frame f >= R shows rendered frame
    #                         cycle_start + (f - cycle_start) % (R - start)
    cycles: bool            # False: the stream ends after R frames

    def index(self, f: int) -> int:
        """The rendered frame that stream frame ``f`` shows; raises past
        the end of a stream that does not cycle."""
        R = len(self.poses)
        if f < R:
            return f
        if not self.cycles:
            raise IndexError(
                f"stream frame {f}: the traffic renders {R} frames and does "
                f"not cycle; the run outlasted its stream")
        return self.cycle_start + (f - self.cycle_start) % (R - self.cycle_start)

    def frame(self, f: int):
        i = self.index(f)
        return self.left[i], self.right[i]


def stream_seed(seed: int) -> int:
    """A 32-bit numpy seed for any whole ``--seed`` (distinct seeds give
    distinct worlds)."""
    return int(np.random.SeedSequence(abs(int(seed))).generate_state(1)[0])


def build(traffic: dict, rig, seed: int, device) -> World:
    """Render the stream a traffic file describes, from ``seed``, with the
    configuration's ``rig``."""
    rng = np.random.RandomState(stream_seed(seed))
    tr, w = traffic["trajectory"], traffic["world"]
    poses = cells.module("trajectories", tr["kind"]).poses(
        tr, traffic["rendered_frames"])
    left, right = cells.module("worlds", w["kind"]).render(
        w, rig, poses, rng, device)
    replay = traffic.get("replay", {})
    return World(rig, left, right, poses, replay.get("cycle_start", 0),
                 bool(replay.get("cycles", False)))
