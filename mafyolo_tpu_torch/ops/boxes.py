"""Box geometry (counterpart of mafyolo_tpu/ops/boxes.py:15-33)."""
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
