"""Greedy NMS keep mask: the CUDA kernel (csrc/greedy_nms.cu) and its plain
PyTorch version.

Counterpart of mafyolo_tpu/ops/pallas_nms.py:pallas_greedy_nms and of the
XLA fixpoint mafyolo_tpu/ops/nms.py:_greedy_nms_mask. `greedy_nms` calls
the custom op `mafyolo::greedy_nms` (registered when this module is
imported), which runs the plain version on a CPU tensor and the kernel on a
CUDA tensor; there is no fallback from one to the other. The op's fake
version gives the keep mask's shape, so torch.export traces through it.
"""
from __future__ import annotations

import ctypes

import torch

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops.boxes import box_iou_pairwise

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"greedy_nms": [_P, _P, _P, _P, _I, _I, ctypes.c_float, _P],
        "nms_bitmatrix": [_P, _P, _I, _I, ctypes.c_float, _P],   # phase A alone
        "nms_scan": [_P, _P, _P, _I, _I, _P]}                    # phase B alone
TILE = 64                  # boxes per word of the suppression bit matrix


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


def greedy_nms_bitmatrix_plain(boxes, valid, iou_thres: float):
    """The same keep mask by the kernel's formulation: the suppression bit
    matrix first (row i holds every j > i with IoU > thr), then one walk over
    chunks of 64 boxes. A chunk starts from the rows of every earlier kept
    box, and resolves inside itself in order: a box that is valid and not
    removed is kept and removes its row."""
    bsz, m = valid.shape
    iou = box_iou_pairwise(boxes.float(), boxes.float())
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=boxes.device)
    sup = (iou > thr) & torch.ones(m, m, dtype=torch.bool, device=boxes.device).triu(1)
    keep = torch.zeros_like(valid)
    for c0 in range(0, m, TILE):
        c1 = min(c0 + TILE, m)
        removed = ~valid[:, c0:c1] | (sup[:, :c0, c0:c1] & keep[:, :c0, None]).any(1)
        for t in range(c1 - c0):
            kept_t = ~removed[:, t]
            keep[:, c0 + t] = kept_t
            removed = removed | (sup[:, c0 + t, c0:c1] & kept_t[:, None])
    return keep


def matrix_words(m: int) -> int:
    """64-bit words of scratch an image needs: ceil(m/64) words a row, rows
    padded to a multiple of 64."""
    nw = -(-m // TILE)
    return nw * nw * TILE


@torch.library.custom_op("mafyolo::greedy_nms", mutates_args=())
def _greedy_nms_op(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The op `mafyolo::greedy_nms`: the plain version on a CPU tensor, the
    kernel on a CUDA tensor, a raise on any other device."""
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
    if b > 65535:
        raise ValueError(f"greedy_nms: batch {b} exceeds the grid's 65535 images")
    boxes, valid = boxes.contiguous(), valid.contiguous()
    if boxes.data_ptr() % 16:              # the kernel loads a box as one float4
        boxes = boxes.clone()
    keep = torch.empty((b, m), dtype=torch.bool, device=boxes.device)
    if b == 0 or m == 0:
        return keep
    sup = _build.scratch(boxes.device, b * matrix_words(m) * 8)
    lib = _build.load("greedy_nms", _SIG)
    err = lib.greedy_nms(boxes.data_ptr(), valid.data_ptr(), sup.data_ptr(),
                         keep.data_ptr(), b, m, float(iou_thres),
                         _build.current_stream(boxes.device))
    _build.check(lib, err, "greedy_nms kernel")
    greedy_nms.launches += 1
    return keep


@_greedy_nms_op.register_fake
def _(boxes, valid, iou_thres):
    return torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)


def greedy_nms(boxes, valid, iou_thres: float):
    """Greedy NMS keep mask; see greedy_nms_plain for the contract. Calls
    the op `mafyolo::greedy_nms`, so that torch.export records the op (and
    not its plain version) in an exported program."""
    return torch.ops.mafyolo.greedy_nms(boxes, valid, float(iou_thres))


greedy_nms.launches = 0
