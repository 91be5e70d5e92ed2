"""How `correct` is decided: the numbers that hold what the timed path
produced against the plain reference, each with its limit.

Detections (the serve cells). For each checked batch the reference's forward
gives every anchor's class scores and DFL-decoded box. Each served detection
is traced to its anchor: of the anchors at which the reference scores the
served class at TRACE_SHARE of conf_thres or more (those that could have
served it), the one whose reference box lies nearest (L-inf, px); where
there is none, the nearest of all, its distance NOT_TRACED_PX more. Summed
over the checked batches:
  score_gap_median    the median over served detections of |served score -
                      the reference score of its anchor and class|;
  box_gap_px_median   the median distance from a served box to its anchor's
                      reference box;
  count_gap_mean      the mean over images of |served detections - the
                      reference NMS's| over the reference's;
  starved_images      the share of images (with at least STARVED_MIN_REF
                      reference detections) served fewer than half as many
                      detections as the reference gives: an image, or half
                      a batch, left out;
  box_gap_px_worst_image, score_gap_worst_image
                      the largest over images (with at least PART_MIN
                      served detections) of the image's median gap: a fault
                      confined to one image of a batch;
  box_gap_px_worst_class, score_gap_worst_class
                      the largest over classes (with at least PART_MIN
                      served detections) of the class's median gap. The
                      serve cells' heads give each level classes of its own,
                      so this is also the worst head level: a fault confined
                      to one level, or to one class.
The 90th percentiles and largest values come beside the medians. Which of
them a cell holds, and the limits, are its portbench/limits/<workload>.json.
On random heads a served set and the reference's NMS differ where two boxes
of one class sit near the IoU threshold, so detections are not matched one
to one (bf16 against f32 shares 0.035-0.107 of them); tracing each to its
anchor holds every one of them all the same, and the counts are held in
the mean over images or by the halving alone.
"""
from __future__ import annotations

import contextlib

import torch

from portbench.reference import deploy as R

STARVED_MIN_REF = 4     # an image is counted for starved_images from this many
PART_MIN = 4            # an image or a class has a median gap from this many
TRACE_SHARE = 0.5       # of conf_thres: the anchors a served detection may trace to
NOT_TRACED_PX = 1000.0  # added to the gap of a detection no such anchor could serve


@contextlib.contextmanager
def plain_f32(grad: bool = False):
    """float32 convolutions and matmuls without TF32; grad off unless
    asked for."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.set_grad_enabled(grad):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def percentile(sorted_values, p: float) -> float:
    """The p-th percentile of sorted values, linear between ranks (numpy's
    default)."""
    n = len(sorted_values)
    x = (n - 1) * p / 100.0
    lo = int(x)
    hi = min(lo + 1, n - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (x - lo)


def as_served(dets, max_det: int):
    """R.nms's per-image lists -> the padded dict a predict returns."""
    b = len(dets)
    out = {"boxes": torch.zeros(b, max_det, 4), "scores": torch.zeros(b, max_det),
           "classes": torch.zeros(b, max_det, dtype=torch.long),
           "valid": torch.zeros(b, max_det, dtype=torch.bool)}
    for i, d in enumerate(dets):
        k = len(d["scores"])
        out["boxes"][i, :k], out["scores"][i, :k] = d["boxes"], d["scores"]
        out["classes"][i, :k], out["valid"][i, :k] = d["classes"], True
    return out


def detection_gaps(scores, boxes, ref_dets, served, into, conf_thres):
    """Append one batch's gaps to `into` (lists "box", "score", "count",
    "served", "ref", "image"; dicts "class_box", "class_score"): reference
    scores [B, A, nc] and boxes [B, A, 4], the reference NMS's detections,
    the served dict."""
    for i in range(scores.shape[0]):
        k = int(served["valid"][i].sum())
        n_ref = len(ref_dets[i]["scores"])
        into["count"].append(abs(k - n_ref) / max(n_ref, 1))
        into["served"].append(k)
        into["ref"].append(n_ref)
        if k == 0:
            continue
        bx = served["boxes"][i, :k].to(boxes.device, torch.float32)
        sc = served["scores"][i, :k].to(boxes.device, torch.float32)
        cls = served["classes"][i, :k].to(boxes.device)
        far = scores[i][:, cls].T < TRACE_SHARE * conf_thres        # [k, A]
        dist, anchor = ((boxes[i][None] - bx[:, None]).abs().amax(-1)
                        + far * NOT_TRACED_PX).min(1)
        box, score = dist.tolist(), (scores[i][anchor, cls] - sc).abs().tolist()
        into["box"] += box
        into["score"] += score
        if k >= PART_MIN:
            into["image"].append((_median(box), _median(score)))
        for c, b, g in zip(cls.tolist(), box, score):
            into["class_box"].setdefault(c, []).append(b)
            into["class_score"].setdefault(c, []).append(g)


def summary(gaps):
    """Each list's median, 90th percentile and largest value, the count
    gaps' mean, the starved share, and the worst image's and class's
    median gaps."""
    out = {}
    for name, unit in (("box", "box_gap_px"), ("score", "score_gap"), ("count", "count_gap")):
        v = sorted(gaps[name]) or [0.0]
        out[f"{unit}_median"] = percentile(v, 50)
        out[f"{unit}_p90"] = percentile(v, 90)
        out[f"{unit}_max"] = v[-1]
    out["count_gap_mean"] = sum(gaps["count"]) / max(len(gaps["count"]), 1)
    out["count_total_gap"] = abs(sum(gaps["served"]) - sum(gaps["ref"])) / max(sum(gaps["ref"]), 1)
    starved = [k < n / 2 for k, n in zip(gaps["served"], gaps["ref"]) if n >= STARVED_MIN_REF]
    out["starved_images"] = sum(starved) / max(len(starved), 1)
    out["box_gap_px_worst_image"] = max((b for b, _ in gaps["image"]), default=0.0)
    out["score_gap_worst_image"] = max((g for _, g in gaps["image"]), default=0.0)
    for name, unit in (("class_box", "box_gap_px"), ("class_score", "score_gap")):
        out[f"{unit}_worst_class"] = max((_median(v) for v in gaps[name].values()
                                          if len(v) >= PART_MIN), default=0.0)
    return out


def detections(model, checked, mix, quant=None, control=None):
    """The numbers over `checked`, [(device uint8 images, served dict)].
    The reference runs under `quant` (None: f32). With control (a Quant),
    the control's own NMS'd detections stand in for the served ones."""
    gaps = {"box": [], "score": [], "count": [], "served": [], "ref": [], "image": [],
            "class_box": {}, "class_score": {}}
    for imgs, served in checked:
        scores, boxes = model.decoded(imgs, quant)
        ref = R.nms(scores, boxes, mix["conf_thres"], mix["iou_thres"], mix["max_det"])
        if control is not None:
            cs, cb = model.decoded(imgs, control)
            served = as_served(R.nms(cs, cb, mix["conf_thres"], mix["iou_thres"],
                                     mix["max_det"]), mix["max_det"])
        detection_gaps(scores, boxes, ref, served, gaps, mix["conf_thres"])
    return summary(gaps)


def _median(values):
    return percentile(sorted(values), 50)


def held(numbers, limits):
    """{name: {"value", "limit"}}: each number that the cell's limits name,
    beside its limit; every number, with the limit None (which reads as
    not correct), where the cell has no limits yet."""
    names = limits or numbers
    return {k: {"value": float(numbers[k]), "limit": limits.get(k)} for k in names}
