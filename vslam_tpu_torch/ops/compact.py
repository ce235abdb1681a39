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

    valid [..., N] bool -> (idx [..., K] int64 in [0, N) for selected, N for
    empty slots), plus the selection-validity mask [..., K]; each row of a
    stack is compacted on its own.

    newest_first=True returns the LAST valid entries (highest index first),
    used for the in-view landmark cap where newer landmarks win.
    """
    n = valid.shape[-1]
    v = valid.flip(-1) if newest_first else valid
    pos = torch.cumsum(v.to(torch.int64), -1) - 1     # rank among valid
    src = torch.arange(n, device=valid.device)
    if newest_first:
        src = n - 1 - src
    # unselected entries all land in the extra slot k, which is cut off:
    # selected targets are distinct, so the kept slots are deterministic
    tgt = torch.where(v & (pos < k), pos, torch.full_like(pos, k))
    idx = torch.full(valid.shape[:-1] + (k + 1,), n, dtype=torch.int64,
                     device=valid.device)
    idx.scatter_(-1, tgt, src.expand(valid.shape))
    idx = idx[..., :k]
    return idx, idx < n


def take_rows(table, idx):
    """table [..., L, *rest], idx [..., P] -> table's rows idx [..., P,
    *rest], each leading index on its own table (``table[idx]`` where there
    is no leading axis)."""
    lead = idx.dim() - 1
    if lead == 0:
        return table[idx]
    flat = table.reshape((-1,) + table.shape[lead:])
    which = torch.arange(flat.shape[0], device=idx.device).reshape(
        idx.shape[:-1] + (1,))
    return flat[which, idx]


def masked_put_(table, index, values, mask):
    """``table[index] = values`` in place at the entries where ``mask``
    holds, the others dropped, with no host read (a CUDA graph can capture
    it): the reference's ``.at[...].set(..., mode="drop")``.

    ``index`` is a tuple of [n] int64 tensors into ``table``'s leading
    axes, each entry in range; ``values`` is [n, *rest], or one value for
    every entry (a number or a 0-dim tensor); ``mask`` is [n] bool. The
    targets of the masked entries must be distinct unless they all get the
    same value. Selecting the masked entries first would size a tensor by
    their count, a host read. Instead every unmasked entry writes again
    what the first masked entry writes, at its target; where no entry is
    masked, every entry writes back the value the first entry's target
    already holds. No target then receives two different values, so
    ``index_put_`` with duplicate indices is deterministic.
    """
    j = torch.argmax(mask.to(torch.uint8)).reshape(1)   # first masked entry
    first = tuple(i.index_select(0, j) for i in index)  # [1] each
    tgt = tuple(torch.where(mask, i, f) for i, f in zip(index, first))
    held = table[first]                                  # [1, *rest]
    one = not torch.is_tensor(values) or values.dim() == 0
    v_first = values if one else values.index_select(0, j)
    fill = torch.where(mask.any(), v_first, held)
    m = mask.reshape(mask.shape + (1,) * (table.dim() - len(index)))
    table.index_put_(tgt, torch.where(m, values, fill).to(table.dtype))
    return table
