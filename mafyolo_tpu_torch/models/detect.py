"""Anchor-free Detect head decode (counterpart of mafyolo_tpu/models/detect.py).

Head outputs arrive per level as NHWC (feat, cls, reg). Flattening runs over
(h, w) in NHWC order: a flatten straight from NCHW would scramble both the
anchor order and the DFL bins.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def flatten_train_outputs(head_outs: Sequence[Tuple]):
    """-> (feats hw list, cls_scores [B,A,nc], reg_distri [B,A,4*(reg_max+1)])."""
    feats, cls_list, reg_list = [], [], []
    for _, cls, reg in head_outs:
        b, h, w, _ = cls.shape
        feats.append((h, w))
        cls_list.append(cls.reshape(b, h * w, -1))
        reg_list.append(reg.reshape(b, h * w, -1))
    return feats, torch.cat(cls_list, 1), torch.cat(reg_list, 1)


def anchor_points_for(hw_list, strides, grid_cell_offset: float = 0.5,
                      device=None):
    """Eval anchors: (x+0.5, y+0.5) grid-unit centers row-major over (h, w),
    plus the per-anchor stride column."""
    points, stride_col = [], []
    for (h, w), s in zip(hw_list, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        stride_col.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(points, 0), torch.cat(stride_col, 0)


def generate_anchors_train(hw_list, strides, grid_cell_size: float = 5.0,
                           grid_cell_offset: float = 0.5, device=None):
    """Train-mode anchors (detect.py:47-66) -> (anchors [A,4] image-scale
    cell boxes, anchor_points [A,2] image-scale centers, per-level counts,
    stride_tensor [A,1])."""
    anchors, points, counts, stride_col = [], [], [], []
    for (h, w), s in zip(hw_list, strides):
        half = grid_cell_size * s * 0.5
        sx = (torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset) * s
        sy = (torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset) * s
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchors.append(torch.stack([gx - half, gy - half, gx + half, gy + half],
                                   -1).reshape(-1, 4))
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        counts.append(h * w)
        stride_col.append(torch.full((h * w, 1), float(s), device=device))
    return (torch.cat(anchors, 0), torch.cat(points, 0), counts,
            torch.cat(stride_col, 0))


def dist2bbox(distance, anchor_points, box_format: str = "xyxy"):
    """ltrb distances -> boxes (yolov6/utils/general.py:29-40)."""
    lt, rb = distance.chunk(2, -1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if box_format == "xyxy":
        return torch.cat([x1y1, x2y2], -1)
    return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)


def bbox2dist(anchor_points, bbox, reg_max: int):
    """xyxy boxes -> clipped ltrb distances (detect.py:81-86)."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points],
                     -1).clamp(0, reg_max - 0.01)


def dfl_decode(reg_distri, reg_max: int):
    """[..., 4*(reg_max+1)] -> ltrb [..., 4] via softmax expectation (f32)."""
    shape = reg_distri.shape[:-1]
    logits = reg_distri.reshape(*shape, 4, reg_max + 1).float()
    proj = torch.arange(reg_max + 1, dtype=torch.float32,
                        device=reg_distri.device)
    return torch.softmax(logits, -1) @ proj


def decode_eval(head_outs, strides, reg_max: int = 16):
    """Eval decode -> [B, A, 4+1+nc]: xywh image-scale boxes, obj==1, cls."""
    hw_list, cls_scores, reg_distri = flatten_train_outputs(head_outs)
    points, stride_col = anchor_points_for(hw_list, strides,
                                           device=cls_scores.device)
    boxes = dist2bbox(dfl_decode(reg_distri, reg_max), points,
                      box_format="xywh") * stride_col
    ones = torch.ones_like(boxes[..., :1])
    return torch.cat([boxes, ones, cls_scores.to(boxes.dtype)], -1)
