"""Detection loss: VarifocalLoss + IoU + DFL with ATSS -> TAL assignment
(counterpart of mafyolo_tpu/models/losses/loss.py:27-150): every iou_type of
ops/boxes.py, Wise-IoU with its running mean, loss_weight, and use_dfl=False
(a head of 4 raw ltrb channels, reg_max 0).

Targets arrive as a fixed-shape padded tensor [B, Nmax, 5] (cls, xywh
normalized; padded rows cls=-1 and zeros). Masked full-shape reductions take
the place of masked_select. A batch whose target_scores_sum is 0 divides by 1
(loss.py:115-116). Everything runs in f32, outside autocast.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.assigners import atss_assign, tal_assign
from mafyolo_tpu_torch.models.detect import (bbox2dist, dfl_decode, dist2bbox,
                                             flatten_train_outputs,
                                             generate_anchors_train)
from mafyolo_tpu_torch.ops.boxes import iou_loss, wiou_loss, xywh2xyxy
from mafyolo_tpu_torch.parallel import ddp

LOSS_WEIGHT = {"class": 1.0, "iou": 2.5, "dfl": 0.5}   # loss.py:77


def varifocal_loss(pred_score, gt_score, label, alpha: float = 0.75,
                   gamma: float = 2.0):
    """sum(BCE(p, q) * (alpha * p^gamma * (1-y) + q * y)) in f32; the log
    terms clamp at -100 like torch's binary_cross_entropy (loss.py:27-37)."""
    p, q, y = pred_score.float(), gt_score.float(), label.float()
    weight = alpha * p.pow(gamma) * (1.0 - y) + q * y
    bce = -(q * p.clamp(min=1e-45).log().clamp(min=-100.0)
            + (1.0 - q) * (1.0 - p).clamp(min=1e-45).log().clamp(min=-100.0))
    return (bce * weight).sum()


def _df_loss(pred_dist, target):
    """Distribution-focal cross-entropy on ltrb bins (loss.py:40-58):
    pred_dist [..., 4, reg_max+1] logits, target [..., 4] in [0, reg_max)
    -> [..., 1], the mean over the 4 coords."""
    tl = target.long()
    tr = tl + 1
    wl = tr.float() - target
    wr = 1.0 - wl
    logz = torch.logsumexp(pred_dist, -1)
    # target < reg_max - 0.01 (bbox2dist), so tr <= reg_max is a valid bin
    pick_l = pred_dist.gather(-1, tl[..., None]).squeeze(-1)
    pick_r = pred_dist.gather(-1, tr[..., None]).squeeze(-1)
    return ((logz - pick_l) * wl + (logz - pick_r) * wr).mean(-1, keepdim=True)


class Terms(NamedTuple):
    """What detection_loss and the distillation loss share: the VFL, IoU and
    DFL terms, each divided by denom; the f32 class scores [B, A, nc]; the
    positives fg [B, A] and their box weights; the DFL logits [B, A, 4,
    reg_max+1] (None without DFL); Wise-IoU's new running mean (None unless
    iou_type is 'wiou')."""
    cls: torch.Tensor
    iou: torch.Tensor
    dfl: torch.Tensor
    pred_scores: torch.Tensor
    fg: torch.Tensor
    bbox_weight: torch.Tensor
    denom: torch.Tensor
    dist_logits: Optional[torch.Tensor]
    wiou_mean: Optional[torch.Tensor]


def detection_terms(head_outs: Sequence[Tuple], targets, *, use_atss: bool,
                    num_classes: int, img_size: int, strides: Sequence[int], reg_max: int,
                    use_dfl: bool, iou_type: str, wiou_mean=None) -> Terms:
    """Anchors, targets, ATSS or TAL assignment and the class, box and DFL
    terms (loss.py:83-140). Inside a process group of more than one rank (a
    data-parallel step, parallel/ddp.py) denom is the global batch's
    target_scores_sum and Wise-IoU's batch mean is the global batch's."""
    data_parallel = ddp.world_size() > 1
    hw_list, pred_scores, pred_distri = flatten_train_outputs(head_outs)
    pred_scores, pred_distri = pred_scores.float(), pred_distri.float()
    dev = pred_scores.device
    anchors, anchor_points, n_anchors_list, stride_tensor = generate_anchors_train(
        hw_list, strides, device=dev)

    # targets -> image-scale xyxy
    targets = targets.float()
    gt_labels = targets[..., :1]
    gt_bboxes = xywh2xyxy(targets[..., 1:] * img_size)
    mask_gt = (gt_bboxes.sum(-1, keepdim=True) > 0).float()
    gt_bboxes = gt_bboxes * mask_gt

    # predicted boxes in grid units
    anchor_points_s = anchor_points / stride_tensor
    ltrb = dfl_decode(pred_distri, reg_max) if use_dfl else pred_distri
    pred_bboxes = dist2bbox(ltrb, anchor_points_s)
    det_bboxes = pred_bboxes.detach() * stride_tensor
    if use_atss:
        target_labels, target_bboxes, target_scores, fg_mask = atss_assign(
            anchors, n_anchors_list, gt_labels, gt_bboxes, mask_gt, det_bboxes,
            topk=9, num_classes=num_classes)
    else:
        target_labels, target_bboxes, target_scores, fg_mask = tal_assign(
            pred_scores.detach(), det_bboxes, anchor_points, gt_labels, gt_bboxes,
            mask_gt, topk=13, num_classes=num_classes)
    target_bboxes = target_bboxes / stride_tensor
    fg = fg_mask.float()

    # classification: VFL; the background id num_classes one-hots to zeros
    labels_bg = torch.where(fg_mask, target_labels, num_classes)
    one_hot = F.one_hot(labels_bg, num_classes + 1)[..., :num_classes]
    loss_cls = varifocal_loss(pred_scores, target_scores, one_hot)
    tss = target_scores.sum()
    if data_parallel:
        tss = ddp.all_reduce_sum(tss)
    denom = torch.where(tss > 0, tss, torch.ones_like(tss))
    loss_cls = loss_cls / denom

    # box losses, masked full-shape
    bbox_weight = target_scores.sum(-1) * fg
    new_wiou_mean = None
    if iou_type == "wiou":
        mean0 = torch.ones((), device=dev) if wiou_mean is None else wiou_mean
        per_anchor_iou, new_wiou_mean = wiou_loss(
            pred_bboxes, target_bboxes, mean0, mask=fg,
            reduce_sum=ddp.all_reduce_sum if data_parallel else None)
        # wiou has no eps: mask the NaNs of the background out
        per_anchor_iou = per_anchor_iou * fg
        per_anchor_iou = torch.where(torch.isfinite(per_anchor_iou), per_anchor_iou,
                                     torch.zeros_like(per_anchor_iou))
    else:
        per_anchor_iou = iou_loss(pred_bboxes, target_bboxes, iou_type=iou_type,
                                  eps=1e-10)
    loss_iou = (per_anchor_iou * bbox_weight).sum() / denom
    dist_logits = None
    if use_dfl:
        b, a, _ = pred_distri.shape
        dist_logits = pred_distri.reshape(b, a, 4, reg_max + 1)
        target_ltrb = bbox2dist(anchor_points_s, target_bboxes, reg_max)
        per_anchor_dfl = _df_loss(dist_logits, target_ltrb).squeeze(-1)
        loss_dfl = (per_anchor_dfl * bbox_weight).sum() / denom
    else:
        loss_dfl = torch.zeros((), device=dev)
    return Terms(loss_cls, loss_iou, loss_dfl, pred_scores, fg, bbox_weight, denom,
                 dist_logits, new_wiou_mean)


def detection_loss(head_outs: Sequence[Tuple], targets, *, use_atss: bool,
                   num_classes: int, img_size: int = 640,
                   strides: Sequence[int] = (8, 16, 32), reg_max: int = 16,
                   use_dfl: bool = True, iou_type: str = "giou",
                   loss_weight: Optional[Dict[str, float]] = None, wiou_mean=None):
    """-> (total_loss, dict(iou=, dfl=, cls=[, wiou_mean=])), f32 scalars.
    use_atss is epoch < atss_warmup_epoch (loss.py:83). With
    iou_type='wiou' the box loss is Wise-IoU v3 and comps["wiou_mean"] is
    the running mean after this batch (wiou_mean, a scalar tensor, is the
    one before it; None starts at 1). Inside a process group of more than
    one rank every term is divided by the global batch's target_scores_sum
    (detection_terms), so the ranks' losses add up to the global batch's."""
    lw = loss_weight or LOSS_WEIGHT
    t = detection_terms(head_outs, targets, use_atss=use_atss, num_classes=num_classes,
                        img_size=img_size, strides=strides, reg_max=reg_max,
                        use_dfl=use_dfl, iou_type=iou_type, wiou_mean=wiou_mean)
    total = lw["class"] * t.cls + lw["iou"] * t.iou + lw["dfl"] * t.dfl
    comps = {"iou": lw["iou"] * t.iou, "dfl": lw["dfl"] * t.dfl, "cls": lw["class"] * t.cls}
    if t.wiou_mean is not None:
        comps["wiou_mean"] = t.wiou_mean
    return total, comps
