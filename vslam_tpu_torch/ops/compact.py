"""Fixed-size selection: compaction of valid entries and a tie-stable top-k.

Port of ``vslam_tpu/ops/compact.py``, plus ``top_k``: the one top-k of the
port. ``lax.top_k`` puts the lower index first among equal values, and
synthetic images give exactly equal corner responses, so the order among
ties decides which corners, hypotheses and window slots are kept.
``torch.topk`` does not promise an order among ties on the GPU; a stable
descending sort does.
"""

from __future__ import annotations

import torch


def top_k(values, k: int):
    """(values, indices) of the k largest entries along the last axis,
    descending, lower index first among ties (``lax.top_k`` semantics)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def compact_indices(valid, k: int, newest_first: bool = False):
    """Indices of the first (or last) K valid entries.

    valid [N] bool -> (idx [K] int64 in [0, N) for selected, N for empty
    slots), plus the selection-validity mask [K].

    newest_first=True returns the LAST valid entries (highest index first),
    used for the in-view landmark cap where newer landmarks win.
    """
    n = valid.shape[0]
    v = valid.flip(0) if newest_first else valid
    pos = torch.cumsum(v.to(torch.int64), 0) - 1     # rank among valid
    src = torch.arange(n, device=valid.device)
    if newest_first:
        src = n - 1 - src
    # unselected entries all land in the extra slot k, which is cut off:
    # selected targets are distinct, so the kept slots are deterministic
    tgt = torch.where(v & (pos < k), pos, torch.full_like(pos, k))
    idx = torch.full((k + 1,), n, dtype=torch.int64, device=valid.device)
    idx.scatter_(0, tgt, src)
    idx = idx[:k]
    return idx, idx < n
