"""Box geometry and the IoU-loss family (counterpart of mafyolo_tpu/ops/boxes.py:
xywh2xyxy, box_iou_pairwise, the Wise-IoU v3 loss and iou_loss's giou, diou,
ciou, siou and plain iou, with the reference's asymmetric eps)."""
from __future__ import annotations

import math

import torch

# The running mean's momentum (yolov6/utils/wiou.py:14): a 7000-step half-life.
WIOU_MOMENTUM = 1.0 - 0.5 ** (1.0 / 7000.0)
# Wise-IoU v3's focusing: beta's weight is beta / (delta * gamma^(beta - delta)).
WIOU_GAMMA, WIOU_DELTA = 1.9, 3.0


def abs_(x):
    """|x| whose gradient at 0 is 1, as jnp.abs's (torch.abs's is 0): where
    a loss meets an exact zero (aligned centers, equal widths, an L1 target
    hit), both packages then take the same step."""
    return torch.where(x >= 0, x, -x)


def xywh2xyxy(x):
    """[..., 4] center-format -> corner-format."""
    xy, wh = x.chunk(2, -1)
    return torch.cat([xy - wh / 2, xy + wh / 2], -1)


def box_iou_pairwise(box1, box2, eps: float = 1e-7):
    """[..., N, 4] x [..., M, 4] xyxy -> IoU [..., N, M].

    The operation order, inter / (((a1 + a2) - inter) + eps), is the one the
    greedy-NMS kernel (csrc/greedy_nms.cu) reproduces bit for bit.
    """
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:], box2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (box1[..., 2:] - box1[..., :2]).clamp(min=0).prod(-1)
    a2 = (box2[..., 2:] - box2[..., :2]).clamp(min=0).prod(-1)
    return inter / (a1[..., :, None] + a2[..., None, :] - inter + eps)


def wiou_loss(box1, box2, iou_mean, mask=None, reduce_sum=None):
    """Wise-IoU v3 with its non-monotonic focusing (boxes.py:41-80).

    box1/box2: aligned xyxy [..., 4]; iou_mean: the running mean of the
    detached IoU loss, a scalar tensor, which moves BEFORE the loss reads it;
    mask: optional [...] weights of the positives the batch mean is over.
    reduce_sum, if given, sums a tensor over the data-parallel ranks: the
    batch mean is then the global batch's. -> (per-element loss [...], the
    new running mean, f32)."""
    pred_xy = (box1[..., :2] + box1[..., 2:4]) / 2
    tgt_xy = (box2[..., :2] + box2[..., 2:4]) / 2
    pred_wh = box1[..., 2:4] - box1[..., :2]
    tgt_wh = box2[..., 2:4] - box2[..., :2]
    min_c = torch.minimum(box1[..., :4], box2[..., :4])
    max_c = torch.maximum(box1[..., :4], box2[..., :4])
    s_inter = (min_c[..., 2:4] - max_c[..., :2]).clamp(min=0).prod(-1)
    s_union = pred_wh.prod(-1) + tgt_wh.prod(-1) - s_inter
    wh_box = max_c[..., 2:4] - min_c[..., :2]
    l2_box = wh_box.square().sum(-1)
    l2_center = (pred_xy - tgt_xy).square().sum(-1)
    # the reference's 'iou' is the loss-oriented 1 - IoU
    iou = 1.0 - s_inter / s_union
    iou_det = iou.detach()

    if mask is None:
        sums = torch.stack([iou_det.sum(), iou_det.new_tensor(float(iou_det.numel()))])
    else:
        m = mask.float()
        sums = torch.stack([(iou_det * m).sum(), m.sum()])
    if reduce_sum is not None:
        sums = reduce_sum(sums)
    batch_mean = sums[0] / (sums[1] if mask is None else sums[1].clamp(min=1.0))
    new_mean = (1.0 - WIOU_MOMENTUM) * iou_mean + WIOU_MOMENTUM * batch_mean

    dist = torch.exp(l2_center / l2_box.detach())
    loss = dist * iou
    beta = iou_det / new_mean
    alpha = WIOU_DELTA * torch.pow(torch.as_tensor(WIOU_GAMMA, dtype=beta.dtype),
                                   beta - WIOU_DELTA)
    return loss * beta / alpha, new_mean


def iou_loss(box1, box2, iou_type: str = "giou", box_format: str = "xyxy",
             eps: float = 1e-10):
    """Elementwise IoU loss between aligned boxes [..., 4] -> [...]
    (boxes.py:83-136): iou_type giou, diou, ciou, siou or iou, boxes xyxy or
    xywh, with the reference's asymmetric eps (heights get +eps, widths do
    not). CIoU's alpha takes no gradient."""
    if box_format == "xywh":
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    t = iou_type.lower()
    if t == "giou":
        c_area = cw * ch + eps
        iou = iou - (c_area - union) / c_area
    elif t in ("diou", "ciou"):
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        if t == "diou":
            iou = iou - rho2 / c2
        else:
            v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
            alpha = (v / (v - iou + (1 + eps))).detach()
            iou = iou - (rho2 / c2 + v * alpha)
    elif t == "siou":
        s_cw = (b2_x1 + b2_x2 - b1_x1 - b1_x2) * 0.5
        s_ch = (b2_y1 + b2_y2 - b1_y1 - b1_y2) * 0.5
        sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2) + eps
        sin_a1 = abs_(s_cw) / sigma
        sin_a2 = abs_(s_ch) / sigma
        sin_alpha = torch.where(sin_a1 > math.sqrt(2) / 2, sin_a2, sin_a1)
        angle_cost = torch.cos(torch.arcsin(sin_alpha.clamp(-1, 1)) * 2 - math.pi / 2)
        rho_x = (s_cw / (cw + eps)) ** 2
        rho_y = (s_ch / (ch + eps)) ** 2
        gamma = angle_cost - 2
        distance_cost = 2 - torch.exp(gamma * rho_x) - torch.exp(gamma * rho_y)
        omiga_w = abs_(w1 - w2) / torch.maximum(w1, w2)
        omiga_h = abs_(h1 - h2) / torch.maximum(h1, h2)
        shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
        iou = iou - 0.5 * (distance_cost + shape_cost)
    elif t != "iou":
        raise ValueError(f"unknown iou_type {iou_type!r}")
    return 1.0 - iou
