"""PR/F1/AP metrics + confusion matrix, the yolov5-lineage block of the
Evaler's do_pr_metric path (counterpart of mafyolo_tpu/utils/metrics.py:1-159,
kept equal to it)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_ap(recall, precision):
    """101-point interpolated AP for one class/IoU (metrics.py compute_ap).

    The closing sentinel is recall[-1]+0.01, NOT 1.0 (metrics.py:87) -- it
    changes AP for classes whose recall curve never reaches 1."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps=1e-16, plot=False,
                 save_dir=".", names=()):
    """tp [N, T] bool (matched at T IoU thresholds), conf [N], pred_cls [N],
    target_cls [M] -> (p[nc,1000], r[nc,1000], ap[nc,T], f1[nc,1000],
    unique_classes) -- full confidence-swept curves, exactly the reference
    return shape (metrics.py:13-76); the Evaler picks the max-F1 index.

    plot=True renders PR/F1/P/R curve PNGs into save_dir (the reference's
    plot= path, metrics.py:61-70)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    px = np.linspace(0, 1, 1000)
    py = []                  # per-class precision on the recall grid (IoU .5)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = nt[ci]
        n_p = i.sum()
        if n_p == 0 or n_l == 0:
            if plot:
                py.append(np.zeros(1000))
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for ti in range(tp.shape[1]):
            ap[ci, ti], mpre, mrec = compute_ap(recall[:, ti], precision[:, ti])
            if plot and ti == 0:
                py.append(np.interp(px, mrec, mpre))
    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    if plot:
        from pathlib import Path

        from mafyolo_tpu_torch.utils.plots import plot_mc_curve, plot_pr_curve
        names = [names[int(c)] if int(c) < len(names) else str(int(c))
                 for c in unique_classes]
        d = Path(save_dir)
        plot_pr_curve(px, py, ap, d / "PR_curve.png", names)
        plot_mc_curve(px, f1_curve, d / "F1_curve.png", names, ylabel="F1")
        plot_mc_curve(px, p_curve, d / "P_curve.png", names, ylabel="Precision")
        plot_mc_curve(px, r_curve, d / "R_curve.png", names, ylabel="Recall")
    return p_curve, r_curve, ap, f1_curve, unique_classes.astype(int)


def box_iou_np(box1, box2, eps=1e-7):
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    a1 = np.clip(box1[:, 2:] - box1[:, :2], 0, None).prod(-1)
    a2 = np.clip(box2[:, 2:] - box2[:, :2], 0, None).prod(-1)
    return inter / (a1[:, None] + a2[None, :] - inter + eps)


def process_batch(detections, labels, iouv) -> np.ndarray:
    """Match detections [N,6] (xyxy,conf,cls) to labels [M,5] (cls,xyxy) at each
    IoU threshold (metrics.py process_batch). Returns correct [N, len(iouv)]."""
    correct = np.zeros((detections.shape[0], iouv.shape[0]), dtype=bool)
    if not len(labels) or not len(detections):
        return correct
    iou = box_iou_np(labels[:, 1:], detections[:, :4])
    correct_class = labels[:, 0:1] == detections[None, :, 5]
    for ti in range(len(iouv)):
        x = np.nonzero((iou >= iouv[ti]) & correct_class)
        if x[0].shape[0]:
            matches = np.concatenate(
                (np.stack(x, 1).astype(float), iou[x[0], x[1]][:, None]), 1)
            if x[0].shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), ti] = True
    return correct


class ConfusionMatrix:
    """yolov5 confusion matrix (metrics.py ConfusionMatrix)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections, labels):
        if detections is not None and len(detections):
            detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int) if len(labels) else np.zeros(0, int)
        if detections is None or not len(detections):
            for gc in gt_classes:
                self.matrix[self.nc, gc] += 1   # background FN
            return
        detection_classes = detections[:, 5].astype(int)
        if not len(labels):
            for dc in detection_classes:
                self.matrix[dc, self.nc] += 1   # background FP
            return
        iou = box_iou_np(labels[:, 1:], detections[:, :4])
        x = np.nonzero(iou > self.iou_thres)
        if x[0].shape[0]:
            matches = np.concatenate(
                (np.stack(x, 1).astype(float), iou[x[0], x[1]][:, None]), 1)
            if x[0].shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[detection_classes[m1[j]][0], gc] += 1
            else:
                self.matrix[self.nc, gc] += 1
        if n:
            for i, dc in enumerate(detection_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1

    def plot(self, normalize: bool = True, save_dir: str = "", names=()):
        """Render the matrix heatmap PNG (metrics.py ConfusionMatrix.plot,
        metrics.py:226-254)."""
        import os

        from mafyolo_tpu_torch.utils.plots import plot_confusion_matrix
        return plot_confusion_matrix(
            self.matrix, os.path.join(str(save_dir), "confusion_matrix.png"),
            names=names, normalize=normalize)
