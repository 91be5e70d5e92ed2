"""Knowledge-distillation detection loss (counterpart of
mafyolo_tpu/models/losses/distill.py): the VFL + IoU + DFL loss of loss.py
plus
  * class-score KL distillation with a temperature;
  * DFL-distribution KL distillation, its mean over the positives
    re-weighted by the box weights, as the reference does;
  * with distill_feat, channel-wise KL between the heads' stem features
    (each level's spatial softmax);
  * a cosine decay of the distillation terms over epoch_num / max_epoch.
The VFL, IoU and DFL terms are loss.py:detection_terms. The KL identities
are JAX's written out (F.kl_div's defaults differ): KL =
sum p * (log max(p, 1e-12) - log q). The teacher's outputs take no
gradient. Inside a process group of more than one rank (parallel/ddp.py)
every normaliser is the global batch's: target_scores_sum, the positive
count of the DFL term and its KL sum, and the batch size of the feature
term.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from mafyolo_tpu_torch.models.detect import flatten_train_outputs
from mafyolo_tpu_torch.models.losses.loss import detection_terms
from mafyolo_tpu_torch.parallel import ddp

LOSS_WEIGHT = {"class": 1.0, "iou": 2.5, "dfl": 0.5, "cwd": 10.0}   # distill.py:84
DISTILL_WEIGHT = {"class": 1.0, "dfl": 1.0}


def _kl_div_sum(log_p_student, p_teacher):
    """torch's kl_div(log_q, p, reduction='sum') = sum p * (log p - log q)."""
    return (p_teacher * (p_teacher.clamp(min=1e-12).log() - log_p_student)).sum()


def distill_loss_cls(logits_student, logits_teacher, temperature: float):
    """KL of the class scores over the classes, times T^2 (distill.py:37-42)."""
    nc = logits_student.shape[-1]
    s = torch.log_softmax(logits_student.reshape(-1, nc) / temperature, 1)
    t = torch.softmax(logits_teacher.reshape(-1, nc) / temperature, 1)
    return _kl_div_sum(s, t) * temperature ** 2


def distill_loss_cw(s_feats, t_feats, temperature: float = 1.0, batch: Optional[int] = None):
    """Channel-wise KL over each level's spatial softmax, NHWC inputs
    (distill.py:45-59); each level's sum divided by batch * channels
    (batch: the global batch size, by default the inputs'). In f32 whatever
    the features' dtype."""
    total = 0.0
    for sf, tf in zip(s_feats, t_feats):
        sf, tf = sf.float(), tf.float()
        n, h, w, c = sf.shape
        s = torch.log_softmax(sf.permute(0, 3, 1, 2).reshape(n, c, h * w) / temperature, 2)
        t = torch.log_softmax(tf.detach().permute(0, 3, 1, 2).reshape(n, c, h * w)
                              / temperature, 2)
        # kl_div(log_target=True): sum exp(t) * (t - s)
        total = total + (torch.exp(t) * (t - s)).sum() * (temperature ** 2) / (
            (batch or n) * c)
    return total


def distill_loss_dfl(logits_student, logits_teacher, temperature: float = 20.0):
    """Per-row KL sum over the bins, then the mean over rows, times T^2
    (distill.py:62-71)."""
    nbins = logits_student.shape[-1]
    s = torch.log_softmax(logits_student.reshape(-1, nbins) / temperature, 1)
    t = torch.softmax(logits_teacher.detach().reshape(-1, nbins) / temperature, 1)
    kl = (t * (t.clamp(min=1e-12).log() - s)).sum(1)
    return kl.mean() * temperature ** 2


def distill_detection_loss(head_outs: Sequence[Tuple], teacher_outs: Sequence[Tuple], targets,
                           *, epoch_num, max_epoch: int, use_atss: bool, num_classes: int,
                           img_size: int = 640, strides: Sequence[int] = (8, 16, 32),
                           reg_max: int = 16, use_dfl: bool = True, iou_type: str = "giou",
                           temperature: float = 20.0, distill_feat: bool = False):
    """-> (total, dict(iou, dfl, cls, cwd)), f32 scalars (distill.py:74-178).
    teacher_outs: the teacher's (feat, cls, reg) levels on the same images;
    epoch_num may be a float or a tensor. Wise-IoU is not among the
    iou_types, as in JAX's."""
    if iou_type == "wiou":
        raise ValueError(f"unknown iou_type {iou_type!r} for the distillation loss")
    t = detection_terms(head_outs, targets, use_atss=use_atss, num_classes=num_classes,
                        img_size=img_size, strides=strides, reg_max=reg_max,
                        use_dfl=use_dfl, iou_type=iou_type)
    _, t_pred_scores, t_pred_distri = flatten_train_outputs(teacher_outs)
    t_pred_scores = t_pred_scores.float().detach()
    t_pred_distri = t_pred_distri.float().detach()
    dev = t.pred_scores.device

    if use_dfl:
        # the DFL distillation: the KL's mean over the positives' rows (the
        # reference's scalar mean over masked_select-ed rows), times T^2,
        # weighted by each anchor's box weight
        s = torch.log_softmax(t.dist_logits / temperature, -1)
        q = torch.softmax(t_pred_distri.reshape(t.dist_logits.shape) / temperature, -1)
        kl = (q * (q.clamp(min=1e-12).log() - s)).sum(-1)             # [B, A, 4]
        sums = torch.stack([(kl * t.fg[..., None]).sum(), t.fg.sum() * 4])
        if ddp.world_size() > 1:
            sums = ddp.all_reduce_sum(sums)
        kl_mean = sums[0] / sums[1].clamp(min=1.0)
        d_loss_dfl = (kl_mean * temperature ** 2 * t.bbox_weight).sum() / t.denom
    else:
        d_loss_dfl = torch.zeros((), device=dev)

    d_loss_cls = distill_loss_cls(t.pred_scores, t_pred_scores, temperature)
    if distill_feat:
        batch = t.pred_scores.shape[0] * ddp.world_size()
        d_loss_cw = distill_loss_cw([f for f, _, _ in head_outs],
                                    [f for f, _, _ in teacher_outs], batch=batch)
    else:
        d_loss_cw = torch.zeros((), device=dev)

    epoch = torch.as_tensor(epoch_num, dtype=torch.float32, device=dev)
    decay = ((1 - torch.cos(epoch * math.pi / max_epoch)) / 2) * (0.01 - 1) + 1
    d_loss_dfl = d_loss_dfl * decay
    d_loss_cls = d_loss_cls * decay
    d_loss_cw = d_loss_cw * decay

    lw, dw = LOSS_WEIGHT, DISTILL_WEIGHT
    loss_cls_all = t.cls + d_loss_cls * dw["class"]
    loss_dfl_all = t.dfl + d_loss_dfl * dw["dfl"]
    total = (lw["class"] * loss_cls_all + lw["iou"] * t.iou
             + lw["dfl"] * loss_dfl_all + lw["cwd"] * d_loss_cw)
    comps = {"iou": lw["iou"] * t.iou, "dfl": lw["dfl"] * loss_dfl_all,
             "cls": lw["class"] * loss_cls_all, "cwd": lw["cwd"] * d_loss_cw}
    return total, comps
