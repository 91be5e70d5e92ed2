"""Greedy NMS keep mask: the CUDA kernel (csrc/greedy_nms.cu) and its plain
PyTorch version.

Counterpart of mafyolo_tpu/ops/pallas_nms.py:pallas_greedy_nms and of the
XLA fixpoint mafyolo_tpu/ops/nms.py:_greedy_nms_mask. `greedy_nms` runs the
plain version on a CPU tensor and the kernel on a CUDA tensor; there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops.boxes import box_iou_pairwise

_SIG = {"greedy_nms": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]}


def greedy_nms_plain(boxes, valid, iou_thres: float):
    """boxes [B,M,4] score-descending (class offset applied), valid [B,M]
    bool -> keep [B,M] bool.

    Greedy keep is the unique solution of keep[i] = valid[i] & !any_{j<i}
    (keep[j] & iou[j,i] > thr); iterating from keep = valid reaches it in
    suppression-chain-depth steps (one host sync per step)."""
    m = boxes.shape[1]
    iou = box_iou_pairwise(boxes.float(), boxes.float())
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=boxes.device)
    upper = torch.ones(m, m, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (iou > thr) & upper                     # sup[b, j, i]: j can suppress i
    keep = valid.clone()
    for _ in range(m):
        new = valid & ~(sup & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def greedy_nms(boxes, valid, iou_thres: float):
    """Greedy NMS keep mask; see greedy_nms_plain for the contract."""
    if boxes.device.type == "cpu":
        return greedy_nms_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise RuntimeError(f"greedy_nms: unsupported device {boxes.device}")
    b, m, four = boxes.shape
    if four != 4 or boxes.dtype != torch.float32 or valid.shape != (b, m) \
            or valid.dtype != torch.bool or valid.device != boxes.device:
        raise ValueError("greedy_nms: want boxes f32 [B,M,4] and valid bool "
                         f"[B,M] on one device, got {boxes.dtype} "
                         f"{tuple(boxes.shape)} / {valid.dtype} {tuple(valid.shape)}")
    boxes, valid = boxes.contiguous(), valid.contiguous()
    keep = torch.empty((b, m), dtype=torch.bool, device=boxes.device)
    if b == 0 or m == 0:
        return keep
    lib = _build.load("greedy_nms", _SIG)
    err = lib.greedy_nms(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                         b, m, float(iou_thres),
                         torch.cuda.current_stream(boxes.device).cuda_stream)
    _build.check(lib, err, "greedy_nms kernel")
    greedy_nms.launches += 1
    return keep


greedy_nms.launches = 0
