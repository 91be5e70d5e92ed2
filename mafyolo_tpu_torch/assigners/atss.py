"""ATSS warm-up assigner (counterpart of mafyolo_tpu/assigners/atss.py):
per-level top-9 anchors by center distance, IoU threshold mean + std of the
candidates, in-gt-box constraint, highest-IoU conflict resolution,
IoU-weighted soft target scores."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.assigners.common import (candidates_in_gts, dedup_topk_mask,
                                                iou_batched, iou_pairwise_2d,
                                                resolve_conflicts, topk_indices)


@torch.no_grad()
def atss_assign(anc_bboxes, n_level_bboxes, gt_labels, gt_bboxes, mask_gt,
                pd_bboxes=None, topk: int = 9, num_classes: int = 80):
    """anc_bboxes [A,4] image-scale anchor cell boxes; n_level_bboxes the
    per-level anchor counts; gt_labels [B,N,1]; gt_bboxes [B,N,4] xyxy;
    mask_gt [B,N,1]; pd_bboxes [B,A,4] for IoU-soft scores (or None).
    -> (target_labels [B,A] with bg fill, target_bboxes, target_scores, fg bool)."""
    b, n, _ = gt_bboxes.shape
    a = anc_bboxes.shape[0]
    gt_flat = gt_bboxes.reshape(-1, 4)
    overlaps = iou_pairwise_2d(gt_flat, anc_bboxes).reshape(b, n, a)
    gt_centers = torch.stack([(gt_flat[:, 0] + gt_flat[:, 2]) / 2,
                              (gt_flat[:, 1] + gt_flat[:, 3]) / 2], -1)
    ac_centers = torch.stack([(anc_bboxes[:, 0] + anc_bboxes[:, 2]) / 2,
                              (anc_bboxes[:, 1] + anc_bboxes[:, 3]) / 2], -1)
    distances = ((gt_centers[:, None, :] - ac_centers[None, :, :]) ** 2).sum(-1) \
        .sqrt().reshape(b, n, a)

    # per-level top-k nearest candidates
    is_in_candidate, candidate_idxs = [], []
    start = 0
    valid = mask_gt.bool()
    for level_count in n_level_bboxes:
        k = min(topk, level_count)
        idx = topk_indices(-distances[..., start:start + level_count], k)
        candidate_idxs.append(idx + start)
        is_in_candidate.append(dedup_topk_mask(idx, valid.expand_as(idx), level_count))
        start += level_count
    is_in_candidate = torch.cat(is_in_candidate, -1)
    candidate_idxs = torch.cat(candidate_idxs, -1)

    # IoU threshold mean + std (Bessel) over the candidates
    cand_overlaps = torch.where(is_in_candidate > 0, overlaps, 0.0)
    gathered = cand_overlaps.gather(-1, candidate_idxs)
    k_total = gathered.shape[-1]
    mean = gathered.mean(-1, keepdim=True)
    std = (((gathered - mean) ** 2).sum(-1, keepdim=True) / max(k_total - 1, 1)).sqrt()
    is_pos = torch.where(cand_overlaps > mean + std, is_in_candidate, 0.0)

    mask_pos = is_pos * candidates_in_gts(ac_centers, gt_bboxes) * mask_gt
    target_gt_idx, fg_mask, mask_pos = resolve_conflicts(mask_pos, overlaps)

    target_labels = gt_labels.squeeze(-1).long().gather(1, target_gt_idx)
    target_labels = torch.where(fg_mask > 0, target_labels, num_classes)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(-1, -1, 4))
    target_scores = F.one_hot(target_labels, num_classes + 1)[..., :num_classes] \
        .to(gt_bboxes.dtype)
    if pd_bboxes is not None:
        ious = (iou_batched(gt_bboxes, pd_bboxes) * mask_pos).amax(-2)[..., None]
        target_scores = target_scores * ious
    return target_labels, target_bboxes, target_scores, fg_mask.bool()
