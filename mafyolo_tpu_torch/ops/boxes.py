"""Box geometry and the IoU loss (counterpart of mafyolo_tpu/ops/boxes.py:15-33
and :83-136)."""
from __future__ import annotations

import torch


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


def iou_loss(box1, box2, iou_type: str = "giou", eps: float = 1e-10):
    """Elementwise IoU loss between aligned xyxy boxes [..., 4] -> [...]
    (boxes.py:83-136), with the reference's asymmetric eps: heights get +eps,
    widths do not. Only iou_type 'giou', the MAF configs' one, is ported."""
    if iou_type.lower() != "giou":
        raise NotImplementedError(f"iou_type {iou_type!r} is not ported yet "
                                  f"(ROADMAP Queue 1, remaining training variants)")
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    c_area = cw * ch + eps
    return 1.0 - (inter / union - (c_area - union) / c_area)
