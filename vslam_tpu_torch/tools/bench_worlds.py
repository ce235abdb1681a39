"""The benchmark's full-SLAM world, importable by the tools and by
``chip_smoke.py`` so that every consumer measures the identical world and
configuration (the port of ``bench.full_slam_world``, ``bench.py:237-295``).

The world is ``generate_pano_loop`` at 752x480, 1.75 revolutions, seed 2:
a panoramic revisit loop whose second lap comes back to the first lap's
places. The vocabulary (k=10, depth 4, IDF weights) is trained on the
port's own features of every ``num_frames // 24``-th left image. The
TPU upload packing of the original has no counterpart here: the drivers
take the images as they are.
"""

from __future__ import annotations

import numpy as np


def vocabulary_pool(images, frames, num_features: int, device="cuda"):
    """The port's valid descriptors ([n, 256] {0,1} uint8) of the given
    frames' left images, one array per frame."""
    import torch

    from ..frontend.features import extract_features

    pool = []
    for f in frames:
        ft = extract_features(torch.as_tensor(images[f][0]).to(device),
                              num_features=num_features, quality_level=0.001)
        pool.append(ft.bits[ft.valid].cpu().numpy())
    return pool


def train_vocabulary(pool):
    """A k=10, depth-4 vocabulary of the pool's descriptors with IDF
    weights over its images."""
    from ..loop import vocabulary as vocab_mod

    voc = vocab_mod.train(np.concatenate(pool), k=10, depth=4, seed=0)
    vocab_mod.set_idf_weights(voc, pool)
    return voc


def full_slam_world(num_frames: int = 288, num_features: int = 300,
                    device="cuda"):
    """(seq, vocabulary, make_cfg) of the bench's full-SLAM workload; the
    vocabulary's features are extracted on ``device`` (the card unless
    asked otherwise; an error without one). ``make_cfg(full, reloc=None,
    lc=None, gba=None)`` builds the full-SLAM configuration (``full=True``)
    or the VO control with the same keyframe hygiene (``full=False``);
    ``reloc``, ``lc`` and ``gba`` override one switch each."""
    from .. import resolve_device
    from ..config import SlamConfig
    from ..synthetic_pano import generate_pano_loop

    dev = resolve_device(device)
    seq = generate_pano_loop(num_frames=num_frames, width=752, height=480,
                             revolutions=1.75, seed=2)
    pool = vocabulary_pool(seq.images,
                           range(0, num_frames, max(1, num_frames // 24)),
                           num_features, dev)

    def make_cfg(full, reloc=None, lc=None, gba=None):
        return SlamConfig(
            num_features=num_features, ransac_hypotheses=128,
            max_landmarks=32768, max_keyframes=128,
            max_inview_landmarks=512, window_cams=24,
            # the window BA keeps the 4 newest in-window observations per
            # landmark and truncates at 4096 observations (of ~4600 at the
            # peak): with 300 features this starves the geometry so that
            # drift accrues and the recovery machinery has work to do
            window_points=2048, window_obs=4096, ba_obs_per_lm=4,
            ba_max_iters=10,
            enable_relocalization=full if reloc is None else reloc,
            enable_loop_closure=full if lc is None else lc,
            enable_gba_after_loop=full if gba is None else gba,
            new_kf_min_inliers=60,
            kf_require_tracked=True,  # same keyframe hygiene in both arms
            loop_closing_time_threshold=20, quality_level=0.001,
            match_max_dist_2d=30.0)

    return seq, train_vocabulary(pool), make_cfg
