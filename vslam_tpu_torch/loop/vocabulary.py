"""Binary bag-of-visual-words vocabulary tree.

Port of ``vslam_tpu/loop/vocabulary.py``. The host part is a copy of the
reference's numpy code (the ``Vocabulary`` dataclass, hierarchical binary
k-majority ``train``, ``synthetic_vocab``, ``set_idf_weights``, the numpy
descent ``transform_np``, TF-IDF ``bow_from_words`` and the DBoW2 L1
score); ``tests/test_torch_port.py`` holds each function's source equal
to the original. The device part is ``_descend``, the batched greedy
tree descent (TemplatedVocabulary.h:1127-1193), in PyTorch, and
``DeviceVocabulary``, which keeps the tree's arrays on one device.

The vocabulary is the system's only trained parameter set;
``from_arrays`` carries one across from the reference (any object or
mapping with the ``Vocabulary`` field names); ``load_dbow2_text`` and
``save_dbow2_text`` read and write DBoW2's text format (the numpy parser
of the reference; ``_vocab_from_flat`` and the writer are copies).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Vocabulary:
    k: int                    # branching factor
    depth: int                # levels
    node_desc: np.ndarray     # [num_nodes, 256] uint8 bits
    children: np.ndarray      # [num_nodes, k] int32, -1 pad
    is_leaf: np.ndarray       # [num_nodes] bool
    word_of_node: np.ndarray  # [num_nodes] int32 (-1 if internal)
    node_of_word: np.ndarray  # [num_words] int32
    weights: np.ndarray       # [num_words] float32 (idf)
    parent: np.ndarray        # [num_nodes] int32
    level: np.ndarray         # [num_nodes] int32 (root=0)

    @property
    def num_words(self) -> int:
        return len(self.node_of_word)

    def node_at_level_up(self, levels_up: int) -> np.ndarray:
        """[num_words] ancestor node id ``levels_up`` above each word.

        DBoW2's FeatureVector groups features by this ancestor
        (TemplatedVocabulary.h transform(..., levelsup)).
        """
        anc = self.node_of_word.copy()
        for _ in range(levels_up):
            up = self.parent[anc]
            anc = np.where(up >= 0, up, anc)
        return anc


# ---------------------------------------------------------------------------
# Training: hierarchical binary k-majority
# ---------------------------------------------------------------------------

def _hamming_np(a, b):
    """a [N, 256], b [M, 256] {0,1} -> [N, M] int distances."""
    return (a[:, None, :] != b[None, :, :]).sum(-1)


def _kmajority(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-means: majority-vote centroids, Hamming assignment."""
    n = descs.shape[0]
    k = min(k, n)
    # k-means++-ish init: first random, rest farthest-point
    centers = [descs[rng.randint(n)]]
    for _ in range(k - 1):
        d = _hamming_np(descs, np.stack(centers)).min(1)
        probs = d.astype(np.float64)
        s = probs.sum()
        if s <= 0:
            centers.append(descs[rng.randint(n)])
            continue
        centers.append(descs[rng.choice(n, p=probs / s)])
    centers = np.stack(centers)
    for _ in range(iters):
        assign = _hamming_np(descs, centers).argmin(1)
        for j in range(k):
            sel = descs[assign == j]
            if len(sel) == 0:
                continue
            centers[j] = (sel.mean(0) > 0.5).astype(np.uint8)
    assign = _hamming_np(descs, centers).argmin(1)
    return centers, assign


def train(descriptors: np.ndarray, k: int = 10, depth: int = 4,
          seed: int = 0) -> Vocabulary:
    """Build a k^depth-word vocabulary from training descriptors [N, 256]."""
    rng = np.random.RandomState(seed)
    descriptors = np.asarray(descriptors, dtype=np.uint8)

    node_desc = [np.zeros(256, np.uint8)]  # root placeholder
    children: list = [[]]
    parent = [-1]
    level = [0]
    is_leaf = [False]

    def split(node_id: int, descs: np.ndarray, lvl: int):
        if lvl >= depth or len(descs) < k or len(np.unique(descs, axis=0)) < 2:
            is_leaf[node_id] = True
            return
        centers, assign = _kmajority(descs, k, rng)
        for j in range(centers.shape[0]):
            sel = descs[assign == j]
            if len(sel) == 0:
                continue
            cid = len(node_desc)
            node_desc.append(centers[j])
            children.append([])
            parent.append(node_id)
            level.append(lvl + 1)
            is_leaf.append(False)
            children[node_id].append(cid)
            split(cid, sel, lvl + 1)

    split(0, descriptors, 0)

    n_nodes = len(node_desc)
    ch = np.full((n_nodes, k), -1, np.int32)
    for i, cs in enumerate(children):
        if cs:
            ch[i, :len(cs)] = cs
        else:
            is_leaf[i] = True
    is_leaf_arr = np.asarray(is_leaf)
    word_of_node = np.full(n_nodes, -1, np.int32)
    leaf_ids = np.nonzero(is_leaf_arr)[0]
    word_of_node[leaf_ids] = np.arange(len(leaf_ids))

    voc = Vocabulary(
        k=k, depth=depth,
        node_desc=np.stack(node_desc),
        children=ch,
        is_leaf=is_leaf_arr,
        word_of_node=word_of_node,
        node_of_word=leaf_ids.astype(np.int32),
        weights=np.ones(len(leaf_ids), np.float32),
        parent=np.asarray(parent, np.int32),
        level=np.asarray(level, np.int32),
    )
    # idf weights from the training corpus treated as one document per
    # descriptor batch is meaningless; use uniform weights by default and
    # let callers call set_idf_weights with per-image descriptor sets.
    return voc


def synthetic_vocab(k: int = 10, depth: int = 6, seed: int = 0,
                    flips_per_level: int = 12) -> Vocabulary:
    """Procedurally generate an ORBvoc-scale tree (k=10, L=6 -> 1e6 words).

    The real ORBvoc.txt (loaded by the reference at slam.cpp:370-380) is a
    k-majority clustering of millions of ORB descriptors; training one in CI
    is infeasible, but validating the descent/parse/scoring machinery at
    that scale only needs a tree with the same *structure*: each child's
    descriptor = parent's with ``flips_per_level`` random bits flipped, so
    descriptors sampled near a leaf descend back to it (the greedy
    per-level argmin prefers the true ancestor as long as query noise stays
    below ~2x the sibling distance). Fully vectorized level-by-level build;
    1.11M nodes in seconds.
    """
    rng = np.random.RandomState(seed)
    level_descs = [np.zeros((1, 256), np.uint8)]
    level_sizes = [1]
    for lvl in range(depth):
        par = level_descs[-1]
        n_child = par.shape[0] * k
        child = np.repeat(par, k, axis=0)
        # ~flips_per_level random bit flips per child
        mask = rng.rand(n_child, 256) < (flips_per_level / 256.0)
        child = child ^ mask.astype(np.uint8)
        level_descs.append(child)
        level_sizes.append(n_child)

    n_nodes = sum(level_sizes)
    node_desc = np.concatenate(level_descs)
    starts = np.cumsum([0] + level_sizes)          # level start offsets
    parent = np.full(n_nodes, -1, np.int32)
    level = np.zeros(n_nodes, np.int32)
    children = np.full((n_nodes, k), -1, np.int32)
    for lvl in range(1, depth + 1):
        ids = np.arange(level_sizes[lvl], dtype=np.int32) + starts[lvl]
        parent[ids] = starts[lvl - 1] + np.arange(level_sizes[lvl]) // k
        level[ids] = lvl
    for lvl in range(depth):
        pids = np.arange(level_sizes[lvl], dtype=np.int32) + starts[lvl]
        cids = (starts[lvl + 1]
                + np.arange(level_sizes[lvl + 1]).reshape(-1, k))
        children[pids] = cids
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[starts[depth]:] = True
    word_of_node = np.full(n_nodes, -1, np.int32)
    leaf_ids = np.nonzero(is_leaf)[0].astype(np.int32)
    word_of_node[leaf_ids] = np.arange(len(leaf_ids))
    return Vocabulary(
        k=k, depth=depth, node_desc=node_desc, children=children,
        is_leaf=is_leaf, word_of_node=word_of_node, node_of_word=leaf_ids,
        weights=np.ones(len(leaf_ids), np.float32), parent=parent,
        level=level,
    )


def set_idf_weights(voc: Vocabulary, image_descs: list) -> None:
    """DBoW2-style idf: log(N_images / N_images containing word)."""
    n_img = len(image_descs)
    counts = np.zeros(voc.num_words, np.int64)
    for d in image_descs:
        w, _ = transform_np(voc, d)
        counts[np.unique(w)] += 1
    with np.errstate(divide="ignore"):
        idf = np.log(n_img / np.maximum(counts, 1e-9))
    idf[counts == 0] = 0.0
    voc.weights = idf.astype(np.float32)


# ---------------------------------------------------------------------------
# Transform (tree descent)
# ---------------------------------------------------------------------------

def transform_np(voc: Vocabulary, descs: np.ndarray):
    """Reference numpy descent: descs [N, 256] -> (word ids [N], node path)."""
    descs = np.asarray(descs, dtype=np.uint8)
    cur = np.zeros(len(descs), np.int32)
    for _ in range(voc.depth):
        ch = voc.children[cur]                      # [N, k]
        valid = ch >= 0
        cd = voc.node_desc[np.clip(ch, 0, None)]    # [N, k, 256]
        d = (cd != descs[:, None, :]).sum(-1)
        d = np.where(valid, d, 999)
        nxt = ch[np.arange(len(descs)), d.argmin(1)]
        done = ~valid.any(1)
        cur = np.where(done, cur, nxt)
    return voc.word_of_node[cur], cur


# ---------------------------------------------------------------------------
# Device descent
# ---------------------------------------------------------------------------

def _descend(node_desc, children, word_of_node, bits, valid, depth: int):
    """Batched greedy tree descent (TemplatedVocabulary.h:1127-1193).

    node_desc [Nn, 256] uint8, children [Nn, k] int32 (-1 pad),
    word_of_node [Nn] int32; bits [N, 256] {0,1} uint8, valid [N] bool.
    Returns word ids [N] int32 (-1 where invalid). At each level every
    descriptor moves to its nearest child by Hamming distance; among
    equally near children the lowest child index wins (``jnp.argmin``'s
    rule, taken here explicitly rather than from ``torch.argmin``). A node
    without children keeps the descriptor where it is.
    """
    n = bits.shape[0]
    k = children.shape[1]
    cur = torch.zeros(n, dtype=torch.int64, device=bits.device)
    iota = torch.arange(k, device=bits.device)
    for _ in range(depth):
        ch = children[cur].to(torch.int64)                     # [N, k]
        ok = ch >= 0
        cd = node_desc[torch.clamp(ch, min=0)]                  # [N, k, 256]
        d = (cd != bits[:, None, :]).sum(-1)                    # [N, k]
        d = torch.where(ok, d, torch.full_like(d, 999))
        best = d.min(dim=1, keepdim=True).values
        first = torch.where(d == best, iota, k).min(dim=1).values
        nxt = torch.gather(ch, 1, first[:, None])[:, 0]
        cur = torch.where(ok.any(dim=1), nxt, cur)
    w = word_of_node[cur]
    return torch.where(valid, w, torch.full_like(w, -1)).to(torch.int32)


class DeviceVocabulary:
    """Vocabulary arrays resident on one device + the batched descent."""

    def __init__(self, voc: Vocabulary, device):
        self.voc = voc
        self.k = voc.k
        self.depth = voc.depth
        self.node_desc = torch.as_tensor(voc.node_desc, device=device)
        self.children = torch.as_tensor(voc.children, device=device)
        self.word_of_node = torch.as_tensor(voc.word_of_node, device=device)
        self.weights = torch.as_tensor(voc.weights, device=device)

    def words(self, bits, valid):
        """bits [N, 256] {0,1} -> word ids [N] int32 (-1 invalid)."""
        return _descend(self.node_desc, self.children, self.word_of_node,
                        bits, valid, self.depth)


def from_arrays(src) -> Vocabulary:
    """A ``Vocabulary`` from any object or mapping with its field names
    (the reference's ``Vocabulary`` included): the arrays are copied with
    the reference's dtypes."""
    get = src.get if isinstance(src, dict) else (
        lambda name: getattr(src, name))
    dtypes = dict(node_desc=np.uint8, children=np.int32, is_leaf=bool,
                  word_of_node=np.int32, node_of_word=np.int32,
                  weights=np.float32, parent=np.int32, level=np.int32)
    return Vocabulary(k=int(get("k")), depth=int(get("depth")),
                      **{name: np.array(get(name), dtype=dt)
                         for name, dt in dtypes.items()})


# ---------------------------------------------------------------------------
# BoW vectors + L1 scoring (DBoW2 TF_IDF + L1_NORM semantics)
# ---------------------------------------------------------------------------

def bow_from_words(voc: Vocabulary, words: np.ndarray) -> dict:
    """word ids [N] (−1 ignored) -> {word: weight}, L1-normalized TF-IDF."""
    words = words[words >= 0]
    if len(words) == 0:
        return {}
    uniq, counts = np.unique(words, return_counts=True)
    w = counts.astype(np.float64) * voc.weights[uniq]
    s = w.sum()
    if s <= 0:
        return {}
    w = w / s
    return {int(u): float(x) for u, x in zip(uniq, w) if x > 0}


def l1_score(v1: dict, v2: dict) -> float:
    """DBoW2 L1 score (ScoringObject.cpp:23-67): 1 - 0.5*|v1 - v2|_1.

    Computed sparsely over the intersection:
    s = 0.5 * sum_{i in both} (|vi| + |wi| - |vi - wi|).
    """
    if len(v2) < len(v1):
        v1, v2 = v2, v1
    s = 0.0
    for k, a in v1.items():
        b = v2.get(k)
        if b is not None:
            s += abs(a) + abs(b) - abs(a - b)
    return 0.5 * s


# ---------------------------------------------------------------------------
# DBoW2 text format I/O (TemplatedVocabulary.h:1338-1419)
# ---------------------------------------------------------------------------

def load_dbow2_text(path: str) -> Vocabulary:
    """Parse DBoW2's ORBvoc.txt-style format into dense arrays.

    Line 1: "k L scoring_id weighting_id". Then one line per non-root node:
    "parent_id is_leaf b0 .. b31 weight" with 32 descriptor bytes.
    """
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        parents, leaf_flags, descs, wts = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf_flags.append(int(parts[1]) != 0)
            descs.append([int(x) for x in parts[2:34]])
            wts.append(float(parts[34]))
    return _vocab_from_flat(
        k, depth,
        np.asarray(parents, np.int32),
        np.asarray(leaf_flags, bool),
        np.asarray(descs, np.uint8).reshape(len(parents), 32),
        np.asarray(wts, np.float64),
    )


def _vocab_from_flat(k, depth, parents, leaf_flags, desc_bytes, weights):
    """Assemble a Vocabulary from per-node flat arrays (root implicit)."""
    n = len(parents) + 1  # + root
    node_parent = np.concatenate([[-1], parents + 0]).astype(np.int32)
    # nodes are listed in DBoW2 creation order; ids are 1..n-1
    shifts = np.arange(8, dtype=np.uint8)
    bits = ((desc_bytes[:, :, None] >> shifts) & 1).reshape(len(parents), 256)
    node_desc = np.concatenate([np.zeros((1, 256), np.uint8), bits])
    is_leaf = np.concatenate([[False], leaf_flags])
    # children table, vectorized (ORBvoc has ~1.1M nodes — python loops
    # here dominated load time): group node ids by parent via a stable
    # sort, rank within each group, scatter into the [n, k] table.
    ch = np.full((n, k), -1, np.int32)
    if n > 1:
        ids = np.arange(1, n, dtype=np.int64)
        par = node_parent[1:].astype(np.int64)
        order = np.argsort(par, kind="stable")
        sp = par[order]
        sid = ids[order]
        first = np.zeros(len(sp), bool)
        first[0] = True
        first[1:] = sp[1:] != sp[:-1]
        group_start = np.where(first, np.arange(len(sp)), 0)
        group_start = np.maximum.accumulate(group_start)
        rank = np.arange(len(sp)) - group_start
        keep = rank < k
        ch[sp[keep], rank[keep]] = sid[keep]
    word_of_node = np.full(n, -1, np.int32)
    leaf_ids = np.nonzero(is_leaf)[0]
    word_of_node[leaf_ids] = np.arange(len(leaf_ids))
    # levels: one vectorized parent-hop per pass propagates one level
    # (node ids are in creation order, so parents precede children)
    level = np.zeros(n, np.int32)
    for _ in range(int(depth) + 1):
        level[1:] = level[node_parent[1:]] + 1
    w = np.zeros(len(leaf_ids), np.float32)
    leaf_weights = np.concatenate([[0.0], weights])[leaf_ids]
    w[:] = leaf_weights
    return Vocabulary(
        k=k, depth=depth, node_desc=node_desc, children=ch, is_leaf=is_leaf,
        word_of_node=word_of_node, node_of_word=leaf_ids.astype(np.int32),
        weights=w, parent=node_parent, level=level,
    )


def save_dbow2_text(voc: Vocabulary, path: str) -> None:
    """Write the DBoW2 text format (inverse of load_dbow2_text).

    Vectorized (byte packing + row formatting in bulk) so ORBvoc-scale
    trees (~1.1M nodes) write in seconds, not minutes.
    """
    n = len(voc.parent)
    by_all = (voc.node_desc.reshape(n, 32, 8).astype(np.uint16)
              * (1 << np.arange(8, dtype=np.uint16))).sum(-1)   # [n, 32]
    w_all = np.where(voc.is_leaf & (voc.word_of_node >= 0),
                     voc.weights[np.clip(voc.word_of_node, 0, None)], 0.0)
    leaf_int = voc.is_leaf.astype(np.int8)
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")
        chunk = 65536
        for lo in range(1, n, chunk):
            hi = min(lo + chunk, n)
            rows = [
                f"{voc.parent[i]} {leaf_int[i]} "
                + " ".join(map(str, by_all[i])) + f" {w_all[i]}"
                for i in range(lo, hi)
            ]
            f.write("\n".join(rows) + "\n")
