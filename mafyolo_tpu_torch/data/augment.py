"""Host-side image augmentation, numpy and cv2 (counterpart of
mafyolo_tpu/data/augment.py:22-288).

Every function takes an explicit numpy Generator, so a sample is
reproducible per (seed, epoch, index). Images are BGR uint8 HWC. `cv2` is
imported inside the functions that call it, never at module level: the
card's machine has none, and its train path (device augmentation,
data/device_aug.py) needs only `letterbox` of an image already at its size,
whose border is written with numpy, bit-equal to
`cv2.copyMakeBorder(..., BORDER_CONSTANT)`.
"""
from __future__ import annotations

import math

import numpy as np

GRAY = (114, 114, 114)


def letterbox(im, new_shape=(640, 640), color=GRAY, auto=True, scaleup=True,
              stride=32, return_int=False):
    """Resize + pad keeping aspect ratio -> (image, ratio, (dw, dh)), or
    (image, ratio, (left, top)) with return_int."""
    shape = im.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = np.mod(dw, stride), np.mod(dh, stride)
    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        import cv2
        im = cv2.resize(im, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    h, w = im.shape[:2]
    out = np.full((h + top + bottom, w + left + right, im.shape[2]), color, im.dtype)
    out[top:top + h, left:left + w] = im
    if not return_int:
        return out, r, (dw, dh)
    return out, r, (left, top)


def augment_hsv(im, rng: np.random.Generator, hgain=0.5, sgain=0.5, vgain=0.5):
    """In-place HSV jitter via LUTs."""
    if not (hgain or sgain or vgain):
        return
    import cv2
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(im, cv2.COLOR_BGR2HSV))
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(im.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(im.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(im.dtype)
    im_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat),
                        cv2.LUT(val, lut_val)))
    cv2.cvtColor(im_hsv, cv2.COLOR_HSV2BGR, dst=im)


_ALBUMENTATIONS_PIPE = None


def albumentations_transform(im, labels, size=640, rng: np.random.Generator = None):
    """Optional albumentations hook, applied by get_sample when the dataset's
    ``albument`` is on.

    labels are (n,5) cls + normalized xywh. Blur/MedianBlur/ToGray/CLAHE at
    p=0.01, as the JAX package's; a no-op when the albumentations package is
    not installed (it is not, here or on the card's machine).
    """
    global _ALBUMENTATIONS_PIPE
    try:
        import albumentations as A
    except ImportError:
        return im, labels
    import random
    if _ALBUMENTATIONS_PIPE is None:
        _ALBUMENTATIONS_PIPE = A.Compose(
            [A.Blur(p=0.01), A.MedianBlur(p=0.01), A.ToGray(p=0.01),
             A.CLAHE(p=0.01)],
            bbox_params=A.BboxParams(format="yolo",
                                     label_fields=["class_labels"]))
    if rng is not None:
        # albumentations draws from the stdlib/np global RNGs; seed them from
        # the per-(seed,epoch,idx) generator to keep the pipeline reproducible
        random.seed(int(rng.integers(2**31)))
        np.random.seed(int(rng.integers(2**31)))
    new = _ALBUMENTATIONS_PIPE(image=im, bboxes=labels[:, 1:],
                               class_labels=labels[:, 0])
    labels = np.array([[c, *b] for c, b in zip(new["class_labels"],
                                               new["bboxes"])],
                      dtype=np.float32).reshape(-1, 5)
    return new["image"], labels


def mixup(im, labels, im2, labels2, rng: np.random.Generator):
    """Beta(32,32) image blend, labels concatenated."""
    r = rng.beta(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.uint8)
    return im, np.concatenate((labels, labels2), 0)


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """Keep boxes that survive an affine warp; boxes (4,n)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def get_transform_matrix(img_shape, new_shape, degrees, scale, shear, translate,
                         rng: np.random.Generator):
    """Center/rotate+scale/shear/translate matrix."""
    import cv2
    new_height, new_width = new_shape
    C = np.eye(3)
    C[0, 2] = -img_shape[1] / 2
    C[1, 2] = -img_shape[0] / 2
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * new_width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * new_height
    return T @ S @ R @ C, s


def resample_segments(segments, n=1000):
    """Up-sample polygon segments to n points each."""
    out = []
    for s in segments:
        s = np.concatenate((s, s[0:1, :]), axis=0)
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out.append(np.stack([np.interp(x, xp, s[:, i]) for i in range(2)], -1))
    return out


def segment2box(segment, width=640, height=640):
    """Polygon -> inside-image xyxy box."""
    x, y = segment.T
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[inside], y[inside]
    if len(x):
        return np.array([x.min(), y.min(), x.max(), y.max()])
    return np.zeros(4)


def random_affine(img, labels, segments, rng: np.random.Generator, degrees=10,
                  translate=.1, scale=.1, shear=10, new_shape=(640, 640),
                  mask_refine=False):
    """Random affine warp of image + labels (cls,xyxy)."""
    import cv2
    n = len(labels)
    height, width = new_shape
    M, s = get_transform_matrix(img.shape[:2], (height, width), degrees, scale,
                                shear, translate, rng)
    if (M != np.eye(3)).any():
        img = cv2.warpAffine(img, M[:2], dsize=(width, height), borderValue=GRAY)
    if n:
        use_segments = segments is not None and any(
            x is not None and len(x) for x in segments)
        new = np.zeros((n, 4))
        if use_segments and mask_refine:
            segs = resample_segments([s_ for s_ in segments])
            for i, segment in enumerate(segs):
                xy = np.ones((len(segment), 3))
                xy[:, :2] = segment
                xy = (xy @ M.T)[:, :2]
                new[i] = segment2box(xy, width, height)
        else:
            xy = np.ones((n * 4, 3))
            xy[:, :2] = labels[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
            xy = (xy @ M.T)[:, :2].reshape(n, 8)
            x = xy[:, [0, 2, 4, 6]]
            y = xy[:, [1, 3, 5, 7]]
            new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), -1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(box1=labels[:, 1:5].T * s, box2=new.T, area_thr=0.1)
        labels = labels[keep]
        labels[:, 1:5] = new[keep]
    return img, labels


def bbox_ioa(box1, box2, eps=1e-7):
    """Intersection over box2 area, (n,4)x(m,4) xyxy."""
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.T
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.T
    inter = ((np.minimum(b1_x2[:, None], b2_x2)
              - np.maximum(b1_x1[:, None], b2_x1)).clip(0)
             * (np.minimum(b1_y2[:, None], b2_y2)
                - np.maximum(b1_y1[:, None], b2_y1)).clip(0))
    area2 = (b2_x2 - b2_x1) * (b2_y2 - b2_y1) + eps
    return inter / area2


def copy_paste(im, labels, segments, p, rng: np.random.Generator):
    """Segment flip-paste augmentation; labels (n,5) cls,xyxy."""
    import cv2
    n = len(segments)
    if p and n:
        h, w, _ = im.shape
        im_new = np.zeros(im.shape, np.uint8)
        boxes = np.stack([w - labels[:, 3], labels[:, 2], w - labels[:, 1],
                          labels[:, 4]], axis=-1)
        ioa = bbox_ioa(boxes, labels[:, 1:5])
        indexes = np.nonzero((ioa < 0.30).all(1))[0]
        k = round(p * len(indexes))
        for j in rng.choice(indexes, size=k, replace=False) if k else []:
            l, box, s = labels[j], boxes[j], segments[j]
            labels = np.concatenate((labels, [[l[0], *box]]), 0)
            segments.append(np.concatenate((w - s[:, 0:1], s[:, 1:2]), 1))
            cv2.drawContours(im_new, [segments[j].astype(np.int32)], -1,
                             (1, 1, 1), cv2.FILLED)
        result = cv2.flip(im, 1)
        i = cv2.flip(im_new, 1).astype(bool)
        im[i] = result[i]
    return im, labels, segments


def mosaic_augmentation(img_size, imgs, hs, ws, labels, hyp, rng: np.random.Generator,
                        segments=None):
    """4-tile mosaic with jittered center, then copy_paste + random_affine.
    labels are (n,5) cls + normalized xywh per tile."""
    if len(imgs) != 4:
        raise ValueError(f"a mosaic takes 4 tiles, not {len(imgs)}")
    labels4, segment4 = [], []
    s = img_size
    yc, xc = (int(rng.uniform(s // 2, 3 * s // 2)) for _ in range(2))
    img4 = None
    for i in range(4):
        img, h, w = imgs[i], hs[i], ws[i]
        if i == 0:
            img4 = np.full((s * 2, s * 2, img.shape[2]), 114, dtype=np.uint8)
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b

        lbl = labels[i].copy()
        seg = [x.copy() for x in (segments[i] if segments else [])]
        if lbl.size:
            boxes = np.copy(lbl[:, 1:])
            boxes[:, 0] = w * (lbl[:, 1] - lbl[:, 3] / 2) + padw
            boxes[:, 1] = h * (lbl[:, 2] - lbl[:, 4] / 2) + padh
            boxes[:, 2] = w * (lbl[:, 1] + lbl[:, 3] / 2) + padw
            boxes[:, 3] = h * (lbl[:, 2] + lbl[:, 4] / 2) + padh
            lbl[:, 1:] = boxes
            seg = [_xyn2xy(x, w, h, padw, padh) for x in seg]
        labels4.append(lbl)
        segment4.extend(seg)

    labels4 = np.concatenate(labels4, 0)
    for x in (labels4[:, 1:], *segment4):
        np.clip(x, 0, 2 * s, out=x)
    if hyp.get("copy_paste", 0):
        img4, labels4, segment4 = copy_paste(img4, labels4, segment4,
                                             hyp["copy_paste"], rng)
    img4, labels4 = random_affine(
        img4, labels4, segment4, rng, degrees=hyp["degrees"],
        translate=hyp["translate"], scale=hyp["scale"], shear=hyp["shear"],
        new_shape=(img_size, img_size), mask_refine=hyp.get("mask_refine", False))
    return img4, labels4


def _xyn2xy(x, w, h, padw, padh):
    y = np.copy(x)
    y[..., 0] = w * x[..., 0] + padw
    y[..., 1] = h * x[..., 1] + padh
    return y
