"""The benchmark's frozen copies against the port's originals, at small
sizes on the CPU: the rendered world and the plain frontend; and the
stream a traffic file describes."""

import numpy as np
import pytest
import torch

import bench_util  # noqa: F401  (puts the checkout on the path)
from harness import cells, frontend, geometry, stream

sprites = cells.module("worlds", "sprites")
path = cells.module("trajectories", "path")


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_sprite_world_renders_the_ports_images(seed):
    from vslam_tpu_torch import synthetic

    rs = stream.stream_seed(seed)
    seq = synthetic.generate(num_frames=5, num_points=300, width=320,
                             height=240, seed=rs, speed=3.0)
    pts, pat = sprites.sprite_world(np.random.RandomState(rs), 300,
                                    ((-6, 10), (-3, 3), (2, 14)))
    assert np.array_equal(pts, seq.points)
    rig = geometry.make_rig(320, 240, 220.0, 220.0, 160.0, 120.0, 0.11)
    right = geometry.se3_compose(seq.poses,
                                 np.broadcast_to(rig.T_0_1, seq.poses.shape))
    L = sprites.render_sprites(pts, pat, seq.poses, rig.intrinsics[0], 320,
                               240, "cpu", batch=2)
    R = sprites.render_sprites(pts, pat, right, rig.intrinsics[1], 320, 240,
                               "cpu", batch=3)
    for i, (l, r) in enumerate(seq.images):
        assert np.array_equal(L[i], l) and np.array_equal(R[i], r)


def test_path_starts_at_the_identity():
    P = path.poses(dict(kind="path", velocity=[0, 0, 0.03],
                        sway=[[0, 0.4, 170.0]], yaw=[[0.12, 42.3]]), 5)
    assert np.allclose(P[0], [0, 0, 0, 0, 0, 0, 1])
    assert np.allclose(P[1, 2], 0.03)


def test_replay_index_and_the_end_of_a_stream():
    w = stream.World(None, None, None, np.zeros((10, 7)), 4, True)
    assert [w.index(f) for f in (3, 9, 10, 15, 16)] == [3, 9, 4, 9, 4]
    w.cycles = False
    with pytest.raises(IndexError):
        w.index(10)


def test_plain_frontend_is_the_ports():
    from vslam_tpu_torch import synthetic
    from vslam_tpu_torch.frontend.features import extract_features

    seq = synthetic.generate(num_frames=3, num_points=300, seed=5)
    for img in seq.images[1]:
        t = torch.as_tensor(img)
        ours = frontend.extract(t, 400, 0.01, 8)
        port = extract_features(t, num_features=400, quality_level=0.01,
                                min_distance=8)
        assert torch.equal(ours.corners, port.corners)
        assert torch.equal(ours.bits, port.bits)
        assert torch.equal(ours.valid, port.valid)


def test_a_traffic_file_names_its_kinds():
    """``stream.build`` renders a traffic file through the world and
    trajectory kinds it names; the seed deals the textures, the layout
    seed fixes the geometry."""
    rig = geometry.make_rig(160, 120, 110.0, 110.0, 80.0, 60.0, 0.11)
    traffic = dict(world=dict(kind="sprites", box=[[-6, 10], [-3, 3],
                                                   [2, 14]],
                              points_per_m3=0.3, layout_seed=5),
                   trajectory=dict(kind="path", velocity=[0, 0, 0.03]),
                   rendered_frames=3, replay=dict(cycles=False))
    a = stream.build(traffic, rig, 1, "cpu")
    b = stream.build(traffic, rig, 1, "cpu")
    c = stream.build(traffic, rig, 2, "cpu")
    assert np.array_equal(a.left, b.left) and np.array_equal(a.right, b.right)
    assert not np.array_equal(a.left, c.left)
    assert np.array_equal(a.poses, c.poses)
    traffic["world"]["kind"] = "no_such_kind"
    with pytest.raises(FileNotFoundError):
        stream.build(traffic, rig, 1, "cpu")
