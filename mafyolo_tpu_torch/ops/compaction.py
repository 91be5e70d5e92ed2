"""Threshold compaction: indices of mask survivors, in index order.

Counterpart of mafyolo_tpu/ops/compaction.py:compact_mask_indices. The TPU
version avoids gathers and scatters with a tile-count / one-hot-dot scheme;
a GPU scatters cheaply, so this is an inclusive cumsum (each survivor's slot)
and one scatter, with no host sync.
"""
from __future__ import annotations

import torch


def compact_mask_indices(mask, k: int):
    """Indices of the first k True entries along the last axis, in order.

    Args:
      mask: [..., N] bool.
      k:    output capacity.

    Returns:
      idx:   [..., k] int64 -- position of the j-th True entry for j < count;
             0 (in bounds) for j >= count.
      count: [...] int64 -- number of True entries. count > k tells the caller
             survivors were dropped and an exact fallback is needed.
    """
    n = mask.shape[-1]
    count = mask.sum(-1)
    slot = torch.cumsum(mask, -1) - 1
    # entries that are False or beyond capacity land in a dump column k
    slot = torch.where(mask & (slot < k), slot, torch.full_like(slot, k))
    src = torch.arange(n, device=mask.device).expand_as(slot)
    idx = torch.zeros(*mask.shape[:-1], k + 1, dtype=torch.int64,
                      device=mask.device)
    idx.scatter_(-1, slot, src)
    return idx[..., :k], count
