"""SimOTA loss, YOLOX-style (counterpart of mafyolo_tpu/models/losses/simota.py),
for the Head_Simota head (raw cls / reg / obj maps: obj and cls logits, reg =
(xy offset, log wh)).

Per image: decode reg to image-scale boxes; candidate anchors are those whose
center lies inside a gt box or inside its 2.5-stride center square; cost =
cls BCE of sqrt(sigmoid(cls) * sigmoid(obj)) + 3 * -log IoU + 1e5 where an
anchor is not in both, 1e9 for non-candidates and padded gts; dynamic k =
max(int(sum of the top-10 candidate IoUs), 1), each gt taking its k
lowest-cost anchors by a stable rank; an anchor claimed twice goes to the
lower cost, the first gt on a tie (argmin). Losses: IoU (ciou by default) +
L1 on the raw reg + obj BCE over all anchors + cls BCE on the positives,
each summed over the global batch and divided by its positive count (all
reduced over the data-parallel ranks, parallel/ddp.py).

The assignment runs image by image: the [N, A, nc] class cost of a whole
bs32@640 batch would take 10 GB.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops.boxes import abs_, iou_loss
from mafyolo_tpu_torch.parallel import ddp

CENTER_RADIUS = 2.5      # the center square's half-width, in strides (simota.py:62-64)
CLS_WEIGHT, IOU_WEIGHT = 1.0, 3.0      # the matching cost's terms
REG_WEIGHT = 5.0         # the IoU term's weight in the loss


def _decode_levels(head_outs: Sequence[Tuple], strides: Sequence[int]):
    """Per-level (cls, reg, obj) NHWC -> flat decoded and raw [B, A, 5+nc],
    grid shifts [1, A, 2] and strides [1, A, 1] (simota.py:29-47)."""
    decoded, raw, shifts, stride_cols = [], [], [], []
    for (cls, reg, obj), s in zip(head_outs, strides):
        b, h, w, _ = cls.shape
        dev = cls.device
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(1, h * w, 2)
        out = torch.cat([reg, obj, cls], -1).reshape(b, h * w, -1)
        raw.append(out)
        xy = (out[..., :2] + grid) * s
        wh = torch.exp(out[..., 2:4]) * s
        decoded.append(torch.cat([xy, wh, out[..., 4:]], -1))
        shifts.append(grid)
        stride_cols.append(torch.full((1, h * w, 1), float(s), device=dev))
    return (torch.cat(decoded, 1), torch.cat(raw, 1), torch.cat(shifts, 1),
            torch.cat(stride_cols, 1))


def _pairwise_iou_xywh(box1, box2, eps: float = 1e-9):
    """[N,4] x [A,4] xywh -> [N,A] (simota.py:50-60)."""
    lt = torch.maximum(box1[:, None, :2] - box1[:, None, 2:] / 2,
                       box2[None, :, :2] - box2[None, :, 2:] / 2)
    rb = torch.minimum(box1[:, None, :2] + box1[:, None, 2:] / 2,
                       box2[None, :, :2] + box2[None, :, 2:] / 2)
    valid = (lt < rb).all(-1)
    inter = (rb - lt).clamp(min=0).prod(-1) * valid
    a1 = box1[:, 2:].prod(-1)
    a2 = box2[:, 2:].prod(-1)
    return inter / (a1[:, None] + a2[None, :] - inter + eps)


@torch.no_grad()
def _assign_one(boxes, obj, cls, gts, gcls, gmask, centers, stride_flat, *,
                num_classes: int):
    """One image's dynamic-k matching (simota.py:83-132) -> (fg [A], matched
    gt [A], matched IoU [A])."""
    n, a = gts.shape[0], boxes.shape[0]
    lt = gts[:, :2] - gts[:, 2:] / 2
    rb = gts[:, :2] + gts[:, 2:] / 2
    d_box = torch.cat([centers[None] - lt[:, None], rb[:, None] - centers[None]], -1)
    in_boxes = (d_box.amin(-1) > 0.0) & gmask[:, None]                  # [N, A]
    c_lt = gts[:, None, :2] - CENTER_RADIUS * stride_flat[None, :, None]
    c_rb = gts[:, None, :2] + CENTER_RADIUS * stride_flat[None, :, None]
    d_ctr = torch.cat([centers[None] - c_lt, c_rb - centers[None]], -1)
    in_centers = (d_ctr.amin(-1) > 0.0) & gmask[:, None]
    candidate = in_boxes.any(0) | in_centers.any(0)                    # [A]
    in_both = in_boxes & in_centers

    ious = _pairwise_iou_xywh(gts, boxes) * gmask[:, None]             # [N, A]
    iou_cost = -torch.log(ious + 1e-8)
    p = torch.sqrt(torch.sigmoid(cls)[None] * torch.sigmoid(obj)[None, :, None])
    onehot = F.one_hot(gcls, num_classes).float()[:, None]             # [N, 1, nc]
    bce = -(onehot * torch.log(p.clamp(min=1e-12))
            + (1 - onehot) * torch.log((1 - p).clamp(min=1e-12)))
    cls_cost = bce.sum(-1)                                             # [N, A]
    cost = (CLS_WEIGHT * cls_cost + IOU_WEIGHT * iou_cost + 1e5 * ~in_both
            + 1e9 * ~candidate[None, :] + 1e9 * ~gmask[:, None])

    cand_ious = torch.where(candidate[None, :], ious, torch.zeros_like(ious))
    k10 = torch.topk(cand_ious, min(10, a), dim=1).values
    dynamic_k = k10.sum(1).int().clamp(min=1)                          # [N]
    # each anchor's rank in its gt's stable ascending-cost order
    order = torch.argsort(cost, dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(a, device=order.device).expand(n, a))
    match = (ranks < dynamic_k[:, None]) & gmask[:, None] & candidate[None, :]

    claimed = match.sum(0)
    best_gt = torch.where(match, cost, torch.full_like(cost, float("inf"))).argmin(0)
    only_best = F.one_hot(best_gt, n).T.bool() & match
    match = torch.where(claimed[None, :] > 1, only_best, match)
    fg = match.any(0)
    matched_gt = match.to(torch.uint8).argmax(0)                       # the first gt
    matched_iou = (match * ious).sum(0)
    return fg, matched_gt, matched_iou


def _bce_logits(logits, target):
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def simota_loss(head_outs, targets, *, num_classes: int, img_size: int = 640,
                strides: Sequence[int] = (8, 16, 32),
                iou_type: str = "ciou") -> Tuple[torch.Tensor, Dict]:
    """head_outs: per level the raw (cls, reg, obj) NHWC maps; targets
    [B, N, 5] (cls, xywh normalized; padded rows cls -1) -> (total, dict(iou,
    l1, obj, cls)), f32 scalars (simota.py:63-161)."""
    decoded, raw, shifts, stride_col = _decode_levels(head_outs, strides)
    decoded, raw = decoded.float(), raw.float()
    boxes = decoded[..., :4]                   # xywh image-scale
    obj_logits = decoded[..., 4]
    cls_logits = decoded[..., 5:]
    centers = (shifts[0] + 0.5) * stride_col[0]
    stride_flat = stride_col[0, :, 0]

    targets = targets.float()
    gt_cls = targets[..., 0].long().clamp(0, num_classes - 1)
    gt_xywh = targets[..., 1:] * img_size
    mask_gt = (targets[..., 1:].sum(-1) > 0) & (targets[..., 0] >= 0)

    assigned = [_assign_one(boxes[i].detach(), obj_logits[i].detach(), cls_logits[i].detach(),
                            gt_xywh[i], gt_cls[i], mask_gt[i], centers, stride_flat,
                            num_classes=num_classes)
                for i in range(boxes.shape[0])]
    fg, matched_gt, matched_iou = (torch.stack(t) for t in zip(*assigned))

    num_fg = fg.sum().float()
    if ddp.world_size() > 1:
        num_fg = ddp.all_reduce_sum(num_fg)
    num_fg = num_fg.clamp(min=1.0)
    tgt_boxes = gt_xywh.gather(1, matched_gt[..., None].expand(-1, -1, 4))   # [B, A, 4]
    tgt_cls_idx = gt_cls.gather(1, matched_gt)                                # [B, A]
    cls_target = F.one_hot(tgt_cls_idx, num_classes).float() * matched_iou[..., None]

    fgf = fg.float()
    l_iou = (iou_loss(boxes, tgt_boxes, iou_type=iou_type, box_format="xywh")
             * fgf).sum() / num_fg
    l_obj = _bce_logits(obj_logits, fgf).sum() / num_fg
    l_cls = (_bce_logits(cls_logits, cls_target).sum(-1) * fgf).sum() / num_fg
    l1_tgt_xy = tgt_boxes[..., :2] / stride_col[..., 0:1] - shifts
    l1_tgt_wh = torch.log(tgt_boxes[..., 2:] / stride_col[..., 0:1] + 1e-8)
    l1_tgt = torch.cat([l1_tgt_xy, l1_tgt_wh], -1)
    l_l1 = (abs_(raw[..., :4] - l1_tgt).sum(-1) * fgf).sum() / num_fg

    total = REG_WEIGHT * l_iou + l_l1 + l_obj + l_cls
    return total, {"iou": REG_WEIGHT * l_iou, "l1": l_l1, "obj": l_obj, "cls": l_cls}
