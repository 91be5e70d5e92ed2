"""Shared assigner math (counterpart of mafyolo_tpu/assigners/common.py).

Fixed shapes, as in the JAX package: gt rows are padded to a static N with
mask_gt marking the real ones. `topk_indices` takes the place of
jax.lax.top_k: torch.topk does not promise lax.top_k's tie order (the lower
index first), so it is a stable sort.
"""
from __future__ import annotations

import torch


def topk_indices(x, k: int):
    """Indices of the k largest entries along the last dim, ties to the lower
    index first (jax.lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def iou_batched(box1, box2, eps: float = 1e-9):
    """Pairwise IoU: box1 [B,N,4] x box2 [B,M,4] -> [B,N,M]."""
    x11, y11, x12, y12 = (box1[..., i][:, :, None] for i in range(4))
    x21, y21, x22, y22 = (box2[..., i][:, None, :] for i in range(4))
    ow = (torch.minimum(x12, x22) - torch.maximum(x11, x21)).clamp(min=0)
    oh = (torch.minimum(y12, y22) - torch.maximum(y11, y21)).clamp(min=0)
    overlap = ow * oh
    area1 = (x12 - x11).clamp(min=0) * (y12 - y11).clamp(min=0)
    area2 = (x22 - x21).clamp(min=0) * (y22 - y21).clamp(min=0)
    return overlap / (area1 + area2 - overlap + eps)


def iou_pairwise_2d(boxes1, boxes2, eps: float = 1e-6):
    """Pairwise IoU: [N,4] x [M,4] -> [N,M] (iou2d_calculator, mode='iou')."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    overlap = (rb - lt).clamp(min=0).prod(-1)
    area1 = (boxes1[:, 2:] - boxes1[:, :2]).clamp(min=0).prod(-1)
    area2 = (boxes2[:, 2:] - boxes2[:, :2]).clamp(min=0).prod(-1)
    union = area1[:, None] + area2[None, :] - overlap
    return overlap / union.clamp(min=eps)


def candidates_in_gts(xy_centers, gt_bboxes, eps: float = 1e-9):
    """Anchor centers strictly inside gt boxes: xy_centers [A,2], gt_bboxes
    [B,N,4] -> [B,N,A] float mask."""
    xc, yc = xy_centers[None, None, :, 0], xy_centers[None, None, :, 1]
    x1, y1, x2, y2 = (gt_bboxes[..., i][:, :, None] for i in range(4))
    inside = (xc - x1 > eps) & (yc - y1 > eps) & (x2 - xc > eps) & (y2 - yc > eps)
    return inside.to(gt_bboxes.dtype)


def resolve_conflicts(mask_pos, overlaps):
    """Anchors claimed by several gts go to the highest-IoU gt.
    mask_pos, overlaps [B,N,A] -> (target_gt_idx [B,A], fg_mask [B,A], mask_pos).
    argmax takes the first maximum, as jnp.argmax does."""
    n_max_boxes = mask_pos.shape[1]
    fg_mask = mask_pos.sum(-2)
    mask_multi = fg_mask[:, None, :] > 1
    max_idx = overlaps.argmax(1)
    is_max = (torch.arange(n_max_boxes, device=overlaps.device)[None, :, None]
              == max_idx[:, None, :]).to(overlaps.dtype)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2)
    return mask_pos.argmax(-2), fg_mask, mask_pos


def dedup_topk_mask(topk_idx, topk_valid, n: int):
    """The reference's one_hot-sum dedup (tal_assigner.py:124-128): invalid
    entries go to index 0, then any index picked more than once is dropped.
    topk_idx [..., K] -> [..., n] float mask."""
    idx = torch.where(topk_valid, topk_idx, torch.zeros_like(topk_idx))
    counts = torch.zeros((*idx.shape[:-1], n), dtype=torch.int32, device=idx.device)
    counts.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))
    return torch.where(counts > 1, 0, counts).float()
