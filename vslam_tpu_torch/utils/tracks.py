"""Feature tracks: union-find fusion of pairwise matches.

Equivalent of the reference's OpenMVG-derived track builder
(include/visnav/tracks.h:53-221 and union_find.h:36-96):
pairwise feature matches between images are fused into multi-view tracks;
tracks observing inconsistent features in one image are dropped.

Host-side numpy (track building is IO-adjacent bookkeeping, not device
compute); the produced tracks feed the SfM helpers (pipeline/sfm.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np


class UnionFind:
    """Path-compressing disjoint sets over dense int ids."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int32)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


ImageFeature = Tuple[int, int]  # (image id, feature id)


def build_tracks(
    matches: Dict[Tuple[int, int], Iterable[Tuple[int, int]]],
    min_length: int = 2,
) -> Dict[int, Dict[int, int]]:
    """Fuse pairwise matches {(img_i, img_j): [(feat_i, feat_j), ...]} into
    tracks {track_id: {img: feat}}.

    Tracks containing two different features of the same image are
    inconsistent and dropped (tracks.h semantics).
    """
    # index all (image, feature) nodes
    node_of: Dict[ImageFeature, int] = {}

    def node(img, feat):
        key = (img, feat)
        if key not in node_of:
            node_of[key] = len(node_of)
        return node_of[key]

    pairs = []
    for (i, j), ms in matches.items():
        for fi, fj in ms:
            pairs.append((node(i, fi), node(j, fj)))

    uf = UnionFind(len(node_of))
    for a, b in pairs:
        uf.union(a, b)

    groups: Dict[int, List[ImageFeature]] = {}
    for (img, feat), n in node_of.items():
        groups.setdefault(uf.find(n), []).append((img, feat))

    tracks: Dict[int, Dict[int, int]] = {}
    tid = 0
    for members in groups.values():
        imgs = [img for img, _ in members]
        if len(set(imgs)) != len(imgs):
            continue  # inconsistent: two features in one image
        if len(members) < min_length:
            continue
        tracks[tid] = {img: feat for img, feat in members}
        tid += 1
    return tracks


def tracks_in_images(tracks: Dict[int, Dict[int, int]],
                     image_ids: Iterable[int]) -> List[int]:
    """Track ids visible in ALL given images (GetTracksInImages)."""
    image_ids = list(image_ids)
    return [tid for tid, obs in tracks.items()
            if all(i in obs for i in image_ids)]
