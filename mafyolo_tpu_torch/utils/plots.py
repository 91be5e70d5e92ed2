"""Plots: the train-batch grid, PR / metric-confidence curves, the
confusion-matrix heatmap and the val-prediction overlay (counterpart of
mafyolo_tpu/utils/plots.py:24-192).

matplotlib and cv2 are imported inside the functions that use them: without
matplotlib (the card's machine has none) the curve and matrix plots return
None, as the JAX ones do; `plot_train_batch` draws and `plot_val_pred`
reads image files with cv2.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np


def class_colors(n: int = 256) -> np.ndarray:
    """Deterministic bright BGR palette, one row per class id."""
    rng = np.random.default_rng(0)
    return rng.integers(64, 256, (n, 3)).astype(np.int32)


def plot_train_batch(images, targets, paths: Optional[Sequence[str]] = None,
                     names: Optional[Sequence[str]] = None,
                     max_size: int = 1920, max_subplots: int = 16):
    """[B,H,W,3] uint8 BGR + [B,N,5] padded labels (cls, normalized xywh;
    cls -1 pads) -> an annotated grid, BGR uint8."""
    import cv2
    images = np.asarray(images)
    targets = np.asarray(targets)
    if images.dtype != np.uint8:
        images = (images * 255).clip(0, 255).astype(np.uint8)
    bs, h, w = images.shape[:3]
    bs = min(bs, max_subplots)
    ns = int(np.ceil(bs ** 0.5))
    colors = class_colors()
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(bs):
        x, y = w * (i // ns), h * (i % ns)
        mosaic[y:y + h, x:x + w] = images[i]
    scale = max_size / ns / max(h, w)
    if scale < 1:
        h, w = math.ceil(scale * h), math.ceil(scale * w)
        mosaic = cv2.resize(mosaic, (w * ns, h * ns))
    for i in range(bs):
        x, y = w * (i // ns), h * (i % ns)
        cv2.rectangle(mosaic, (x, y), (x + w, y + h), (255, 255, 255), 2)
        if paths:
            cv2.putText(mosaic, os.path.basename(paths[i])[:40], (x + 5, y + 15),
                        cv2.FONT_HERSHEY_COMPLEX, 0.5, (220, 220, 220), 1)
        t = targets[i]
        t = t[t[:, 0] >= 0]
        for cls, cx, cy, bw, bh in t:
            b = [int((cx - bw / 2) * w) + x, int((cy - bh / 2) * h) + y,
                 int((cx + bw / 2) * w) + x, int((cy + bh / 2) * h) + y]
            color = tuple(int(c) for c in colors[int(cls) % len(colors)])
            label = str(names[int(cls)]) if names else str(int(cls))
            cv2.rectangle(mosaic, (b[0], b[1]), (b[2], b[3]), color, 1)
            cv2.putText(mosaic, label, (b[0], b[1] - 5),
                        cv2.FONT_HERSHEY_COMPLEX, 0.5, color, 1)
    return mosaic


def _plt():
    """matplotlib behind an optional import (headless Agg)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


def plot_pr_curve(px, py, ap, save_path, names: Sequence[str] = ()):
    """Precision-recall curves at IoU 0.5 -> PR_curve.png (parity:
    yolov6/utils/metrics.py plot_pr_curve, metrics.py:106-123). px [1000]
    recall grid, py list of per-class precision curves, ap [nc, T]."""
    plt = _plt()
    if plt is None or not len(py):
        return None
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1)        # [1000, nc]
    if 0 < len(names) < 21:
        for i, y in enumerate(py.T):
            ax.plot(px, y, linewidth=1, label=f"{names[i]} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    ax.plot(px, py.mean(1), linewidth=3, color="blue",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    plt.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)
    return save_path


def plot_mc_curve(px, py, save_path, names: Sequence[str] = (),
                  xlabel: str = "Confidence", ylabel: str = "Metric"):
    """Metric-confidence curves (F1/P/R) -> PNG (parity: metrics.py
    plot_mc_curve, metrics.py:126-142). py [nc, 1000]."""
    plt = _plt()
    if plt is None:
        return None
    py = np.asarray(py)
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names[i]}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    plt.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)
    return save_path


def plot_confusion_matrix(matrix, save_path, names: Sequence[str] = (),
                          normalize: bool = True):
    """Confusion-matrix heatmap -> confusion_matrix.png (parity: metrics.py
    ConfusionMatrix.plot, metrics.py:226-254; pure matplotlib instead of
    seaborn). matrix [nc+1, nc+1] with the background row/col last."""
    plt = _plt()
    if plt is None:
        return None
    m = np.asarray(matrix, np.float64)
    nc = m.shape[0] - 1
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-6)
        m[m < 0.005] = np.nan      # don't annotate near-zero cells
    fig, ax = plt.subplots(1, 1, figsize=(12, 9), tight_layout=True)
    im = ax.imshow(np.nan_to_num(m), cmap="Blues", vmin=0.0)
    fig.colorbar(im, ax=ax)
    labels = list(names) + ["background"] if 0 < len(names) < 99 else None
    n = m.shape[0]
    if labels and len(labels) == n:
        ax.set_xticks(range(n))
        ax.set_yticks(range(n))
        ax.set_xticklabels(labels, rotation=90, fontsize=8)
        ax.set_yticklabels(labels, fontsize=8)
    if nc < 30:                    # annotate like the seaborn annot=True path
        thresh = np.nanmax(m) / 2.0 if np.isfinite(m).any() else 0.5
        for i in range(n):
            for j in range(n):
                v = m[i, j]
                if np.isfinite(v) and v > 0:
                    ax.text(j, i, f"{v:.2f}" if normalize else f"{int(v)}",
                            ha="center", va="center", fontsize=7,
                            color="white" if v > thresh else "black")
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)
    return save_path


def plot_val_pred(dets, paths: Sequence[str],
                  names: Optional[Sequence[str]] = None, vis_conf: float = 0.3,
                  vis_max_box_num: int = 5) -> List[np.ndarray]:
    """Per-image detection dicts [{'boxes' [k,4] native xyxy, 'scores',
    'classes'}, ...] + original image paths -> annotated RGB images
    (engine.py:561-577 plot_val_pred)."""
    import cv2
    colors = class_colors()
    out = []
    for det, path in zip(dets, paths):
        img = cv2.imread(path)
        if img is None:
            continue
        boxes = np.asarray(det["boxes"])
        scores = np.asarray(det["scores"])
        classes = np.asarray(det["classes"])
        for j in range(min(len(boxes), vis_max_box_num + 1)):
            if scores[j] < vis_conf:
                break
            cls_id = int(classes[j])
            color = tuple(int(c) for c in colors[cls_id % len(colors)])
            b = boxes[j].astype(int)
            cv2.rectangle(img, (b[0], b[1]), (b[2], b[3]), color, 1)
            label = str(names[cls_id]) if names else str(cls_id)
            cv2.putText(img, f"{label}: {scores[j]:.2f}", (b[0], b[1] - 10),
                        cv2.FONT_HERSHEY_COMPLEX, 0.5, color, 1)
        out.append(img[:, :, ::-1].copy())
    return out
