"""Fused decode + NMS over head outputs (counterpart of mafyolo_tpu/ops/nms.py).

Threshold compaction picks the (anchor, class) pairs above conf_thres, only
those are DFL-decoded, and greedy class-offset NMS (ops/greedy_nms.py, the
hand-written kernel on the card) keeps at most max_det of them. The batch
dimension is explicit where the JAX code vmaps. Every sort that JAX makes
stable, or makes with lax.top_k (ties toward the lower index), is a
torch.sort(stable=True) here: equal-score tie order decides NMS survivors.
"""
from __future__ import annotations

import torch

from mafyolo_tpu_torch.models.detect import dfl_decode, flatten_train_outputs
from mafyolo_tpu_torch.ops.boxes import box_iou_pairwise
from mafyolo_tpu_torch.ops.compaction import compact_mask_indices
from mafyolo_tpu_torch.ops.greedy_nms import greedy_nms

MAX_WH = 4096.0   # class-offset magnitude (reference nms.py:54)


def _take(x, idx):
    """Batched gather along dim 1: x [B, N, ...], idx [B, K] -> [B, K, ...]."""
    return x.gather(1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
                    .expand(*idx.shape, *x.shape[2:]))


def _topk_stable(x, k: int):
    """lax.top_k semantics: k largest along the last axis, ties toward the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _blocked_greedy_select(cand_boxes, off_boxes, scores, cls_idx,
                           iou_thres: float, max_det: int, block: int = 256):
    """Exact greedy NMS + top-max_det over score-DESCENDING candidates
    [B, M], in score-ordered blocks of `block` (mafyolo_tpu/ops/nms.py:54).

    State carries only the top-max_det kept candidates: a kept box dropped
    from it ranks below max_det kept boxes, so nothing it would suppress can
    reach the output. Returns (boxes [B,max_det,4], scores, classes, valid).
    """
    bsz, m = scores.shape
    if m <= block:
        keep = greedy_nms(off_boxes, scores > 0, iou_thres)
        kept_scores = torch.where(keep, scores, torch.zeros_like(scores))
        _, order = torch.sort(-kept_scores, dim=-1, stable=True)
        k = min(max_det, m)
        pad = max_det - k
        order = order[:, :k]
        out_scores = torch.nn.functional.pad(_take(kept_scores, order), (0, pad))
        out_boxes = torch.nn.functional.pad(_take(cand_boxes, order),
                                            (0, 0, 0, pad))
        out_cls = torch.nn.functional.pad(_take(cls_idx, order), (0, pad))
        return out_boxes, out_scores, out_cls, out_scores > 0

    nb = -(-m // block)
    pad_m = nb * block - m
    off_p = torch.nn.functional.pad(off_boxes, (0, 0, 0, pad_m))
    sc_p = torch.nn.functional.pad(scores, (0, pad_m))
    kept_sc = scores.new_zeros((bsz, max_det))
    kept_ix = torch.zeros((bsz, max_det), dtype=torch.int64,
                          device=scores.device)
    for i in range(nb):
        sl = slice(i * block, (i + 1) * block)
        b_off, b_sc = off_p[:, sl], sc_p[:, sl]
        b_ix = torch.arange(i * block, (i + 1) * block,
                            device=scores.device).expand(bsz, block)
        iou_k = box_iou_pairwise(_take(off_p, kept_ix), b_off)   # [B, D, blk]
        sup = ((iou_k > iou_thres) & (kept_sc > 0)[:, :, None]).any(1)
        keep_b = greedy_nms(b_off, (b_sc > 0) & ~sup, iou_thres)
        all_sc = torch.cat([kept_sc, torch.where(keep_b, b_sc,
                                                 torch.zeros_like(b_sc))], 1)
        all_ix = torch.cat([kept_ix, b_ix], 1)
        kept_sc, top_i = _topk_stable(all_sc, max_det)
        kept_ix = all_ix.gather(1, top_i)
    valid = kept_sc > 0
    safe_ix = torch.where(valid, kept_ix, torch.zeros_like(kept_ix))
    boxes = torch.where(valid[..., None], _take(cand_boxes, safe_ix),
                        torch.zeros((), device=scores.device))
    classes = torch.where(valid, cls_idx.gather(1, safe_ix),
                          torch.zeros_like(safe_ix))
    return boxes, kept_sc, classes, valid


def fused_decode_nms(head_outs, strides=(8, 16, 32), reg_max: int = 16,
                     conf_thres: float = 0.03, iou_thres: float = 0.65,
                     max_det: int = 300, pre_nms_topk: int = 2000,
                     compact_k: int = 512):
    """Per-level NHWC head outputs -> dict of padded detections:
    boxes [B,max_det,4] xyxy px, scores [B,max_det], classes [B,max_det]
    int64, valid [B,max_det] bool, score-descending per image.

    Fast path: threshold compaction, exact while every image has <= compact_k
    above-threshold pairs and no anchor has more than two. Otherwise the whole
    batch takes the dense top-pre_nms_topk path (mafyolo_tpu/ops/nms.py:
    280-284). In eager torch that branch costs one host sync (`.item()`) per
    batch.
    """
    hw_list, cls_scores, reg_distri = flatten_train_outputs(head_outs)
    dev = cls_scores.device
    bsz, a, nc = cls_scores.shape
    ma = min(pre_nms_topk, a)
    m = min(pre_nms_topk, a * nc)
    kp = min(compact_k, a * nc)
    zero = torch.zeros((), dtype=cls_scores.dtype, device=dev)

    def anchor_point_at(idx):
        """flat anchor index -> (grid-unit center [...,2], stride [...,1])."""
        off = torch.zeros_like(idx)
        wsel = torch.full_like(idx, hw_list[0][1])
        ssel = torch.full(idx.shape, float(strides[0]), device=dev)
        o = 0
        for (h, w), s in zip(hw_list, strides):
            in_s = idx >= o
            off = torch.where(in_s, o, off)
            wsel = torch.where(in_s, w, wsel)
            ssel = torch.where(in_s, float(s), ssel)
            o += h * w
        local = idx - off
        gy = torch.div(local, wsel, rounding_mode="floor")
        gx = local - gy * wsel
        return torch.stack([gx.float() + 0.5, gy.float() + 0.5], -1), ssel[..., None]

    def decode_boxes(reg_rows, anchor_idx):
        """DFL-decode gathered reg rows at their anchors -> xyxy image px."""
        ltrb = dfl_decode(reg_rows, reg_max)
        pts, sc = anchor_point_at(anchor_idx)
        return torch.cat([(pts - ltrb[..., :2]) * sc,
                          (pts + ltrb[..., 2:]) * sc], -1)

    def offset(boxes, cls_idx):
        return boxes + cls_idx[..., None].to(boxes.dtype) * MAX_WH

    # ---- fast path: compaction + top-2 classes of each surviving anchor
    amx = cls_scores.amax(-1)                                     # [B, A]
    aidx, acount = compact_mask_indices(amx > conf_thres, kp)     # [B, kp]
    aslot = torch.arange(kp, device=dev)
    rows = torch.where((aslot < acount[:, None])[..., None],
                       _take(cls_scores, aidx), zero)             # [B, kp, nc]
    rows = torch.where(rows > conf_thres, rows, zero)
    cls_iota = torch.arange(nc, device=dev).expand_as(rows)
    v1 = rows.amax(-1)
    c1 = torch.where(rows == v1[..., None], cls_iota, nc).amin(-1)
    rest = torch.where(cls_iota == c1[..., None], zero, rows)
    v2 = rest.amax(-1)
    c2 = torch.where(rest == v2[..., None], cls_iota, nc).amin(-1)
    nabove = (rows > zero).sum(-1)                                # [B, kp]
    overflow = torch.maximum(
        torch.where((nabove > 2).any(-1), kp + 1, 0), nabove.sum(-1))
    counts = torch.maximum(acount, overflow)                      # [B]
    if bool((counts > kp).any().item()):
        return _dense(cls_scores, reg_distri, conf_thres, iou_thres, max_det,
                      ma, m, decode_boxes, offset)

    sc2 = torch.cat([v1, v2], 1)                                  # [B, 2kp]
    neg, order = torch.sort(-sc2, dim=-1, stable=True)
    sc_sorted = -neg[:, :kp]
    order = order[:, :kp]
    row_idx = torch.cat([aidx, aidx], 1).gather(1, order)
    cls_idx = torch.where(sc_sorted > zero,
                          torch.cat([c1, c2], 1).gather(1, order), 0)
    cand = decode_boxes(_take(reg_distri, row_idx), row_idx)
    b, s, c, v = _blocked_greedy_select(
        cand, offset(cand, cls_idx), sc_sorted.float(), cls_idx, iou_thres,
        max_det, block=max(512, kp))
    return dict(boxes=b, scores=s, classes=c, valid=v)


def _dense(cls_scores, reg_distri, conf_thres, iou_thres, max_det, ma, m,
           decode_boxes, offset):
    """Overflow path: top-ma anchors, then top-m pairs, blocked greedy NMS."""
    nc = cls_scores.shape[-1]
    zero = torch.zeros((), dtype=cls_scores.dtype, device=cls_scores.device)
    _, anchor_top = _topk_stable(cls_scores.amax(-1), ma)        # [B, ma]
    rows = _take(cls_scores, anchor_top)
    rows = torch.where(rows > conf_thres, rows, zero)
    boxes_ma = decode_boxes(_take(reg_distri, anchor_top), anchor_top)
    top_scores, top_flat = _topk_stable(rows.reshape(rows.shape[0], -1), m)
    row_idx = torch.div(top_flat, nc, rounding_mode="floor")
    cls_idx = top_flat % nc
    cand = _take(boxes_ma, row_idx)
    b, s, c, v = _blocked_greedy_select(
        cand, offset(cand, cls_idx), top_scores.float(), cls_idx, iou_thres,
        max_det)
    return dict(boxes=b, scores=s, classes=c, valid=v)
