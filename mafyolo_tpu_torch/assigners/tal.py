"""Task-aligned label assignment (counterpart of mafyolo_tpu/assigners/tal.py),
fixed shapes: gt rows padded to a static N with mask_gt marking the real ones."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.assigners.common import (candidates_in_gts, dedup_topk_mask,
                                                iou_batched, resolve_conflicts,
                                                topk_indices)


@torch.no_grad()
def tal_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
               topk: int = 13, num_classes: int = 80, alpha: float = 1.0,
               beta: float = 6.0, eps: float = 1e-9):
    """Image-scale coords: pd_scores [B,A,nc] sigmoid scores; pd_bboxes [B,A,4]
    xyxy; anc_points [A,2]; gt_labels [B,N,1]; gt_bboxes [B,N,4] xyxy;
    mask_gt [B,N,1] in {0,1}.
    -> (target_labels [B,A], target_bboxes [B,A,4], target_scores [B,A,nc],
        fg_mask [B,A] bool)."""
    # alignment metric: each gt's class column of pd_scores
    labels = gt_labels.squeeze(-1).long().clamp(0, num_classes - 1)
    bbox_scores = pd_scores.gather(2, labels[:, None, :].expand(-1, pd_scores.shape[1], -1)) \
        .transpose(1, 2)                                       # [B,N,A]
    overlaps = iou_batched(gt_bboxes, pd_bboxes)
    align_metric = bbox_scores ** alpha * overlaps ** beta

    # positive mask: top-k by metric inside the gt box
    mask_in_gts = candidates_in_gts(anc_points, gt_bboxes)
    topk_idx = topk_indices(align_metric * mask_in_gts, topk)
    is_in_topk = dedup_topk_mask(topk_idx, mask_gt.bool().expand_as(topk_idx),
                                 pd_scores.shape[1])
    mask_pos = is_in_topk * mask_in_gts * mask_gt
    target_gt_idx, fg_mask, mask_pos = resolve_conflicts(mask_pos, overlaps)

    target_labels = gt_labels.squeeze(-1).long().gather(1, target_gt_idx).clamp(min=0)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(-1, -1, 4))
    target_scores = F.one_hot(target_labels, num_classes).to(pd_scores.dtype) \
        * (fg_mask[..., None] > 0)

    # normalization
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)
    pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlaps / (pos_align + eps)).amax(-2)[..., None]
    return target_labels, target_bboxes, target_scores * norm, fg_mask.bool()
