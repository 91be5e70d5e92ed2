"""Dataset scan, label cache and the val-time sample (counterpart of
mafyolo_tpu/data/datasets.py:32-414).

An images dir with a sibling labels dir of YOLO txt files (class cx cy w h
normalized, optionally polygon segments); the label cache is the JAX
package's `.labels_cache.npz` in the image directory, same key and layout,
so either package reads what the other wrote. `get_sample` returns numpy
(BGR HWC uint8 + (n,5) labels); padding happens at collation (loader.py).

`cv2` (decode, resize) and PIL (header check) are imported inside the
functions that use them: the card's machine has neither, and a dataset that
overrides `_load_labels` and `load_image` (utils/sample.py:ArrayDataset)
needs neither. Train-time augmentation (mosaic, mixup, affine, HSV, flips)
comes with the trainer.
"""
from __future__ import annotations

import hashlib
import os
import os.path as osp
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mafyolo_tpu_torch.data.augment import letterbox
from mafyolo_tpu_torch.utils.events import LOGGER

IMG_FORMATS = (".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".dng", ".webp")

# PIL exif orientation tag
_ORIENTATION = 0x0112


def check_image(im_file: str):
    """Header-only image verification: PIL verify + header-size read, exif
    orientation swap, corrupt-JPEG restore by re-saving.
    Returns (path, (w, h) | None, warn_msg)."""
    from PIL import Image, ImageOps
    msg = ""
    try:
        im = Image.open(im_file)
        im.verify()
        im = Image.open(im_file)          # reload after verify
        shape = im.size                   # (width, height)
        try:
            exif = im._getexif()
        except Exception:
            exif = None
        if exif and _ORIENTATION in exif and exif[_ORIENTATION] in (6, 8):
            shape = (shape[1], shape[0])
        if shape[0] <= 9 or shape[1] <= 9:
            raise ValueError(f"image size {shape} <10 pixels")
        fmt = (im.format or "").lower()
        if f".{fmt}" not in IMG_FORMATS and fmt != "jpeg":
            raise ValueError(f"invalid image format {im.format}")
        if fmt in ("jpg", "jpeg"):
            with open(im_file, "rb") as f:
                f.seek(-2, 2)
                if f.read() != b"\xff\xd9":   # truncated JPEG
                    ImageOps.exif_transpose(Image.open(im_file)).save(
                        im_file, "JPEG", subsampling=0, quality=100)
                    msg = f"{im_file}: corrupt JPEG restored and saved"
        return im_file, shape, msg
    except Exception as e:  # noqa: BLE001 - a corrupt image is dropped, not fatal
        return im_file, None, f"{im_file}: ignoring corrupt image: {e}"


def img2label_path(img_path: str) -> str:
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def _scan_images(img_dir: str) -> List[str]:
    p = Path(img_dir)
    if p.is_file():
        with open(p) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
    else:
        paths = sorted(str(f) for f in p.rglob("*") if f.suffix.lower() in IMG_FORMATS)
    if not paths:
        raise FileNotFoundError(f"no images found under {img_dir}")
    return paths


def _cache_key(paths: List[str]) -> str:
    h = hashlib.md5()
    for pth in paths:
        st = os.stat(pth)
        h.update(f"{pth}{st.st_size}{st.st_mtime_ns}".encode())
        lb = img2label_path(pth)
        if osp.exists(lb):
            st = os.stat(lb)
            h.update(f"{lb}{st.st_size}{st.st_mtime_ns}".encode())
    return h.hexdigest()


class DetectionDataset:
    """Random-access detection dataset; the val-time sample pipeline."""

    def __init__(self, img_dir: str, img_size: int = 640, augment: bool = False,
                 hyp: Optional[Dict] = None, rect: bool = False, batch_size: int = 16,
                 stride: int = 32, pad: float = 0.0, class_names=None,
                 task: str = "train", rect_bucket: int = 0):
        self.img_dir = img_dir
        self.img_size = img_size
        self.augment = augment
        self.hyp = dict(hyp or {})
        self.rect = rect
        self.rect_bucket = rect_bucket
        self.stride = stride
        self.pad = pad
        self.task = task
        self.class_names = class_names
        self.labels, self.segments, self.shapes = self._load_labels()
        if rect:
            self.batch_indices = np.floor(
                np.arange(len(self.img_paths)) / batch_size).astype(int)
            self._sort_rect(batch_size)

    # ---------- scanning / caching ----------

    def _load_labels(self):
        """Set self.img_paths; -> (labels, segments, shapes (w, h) float64)."""
        self.img_paths = _scan_images(self.img_dir)
        cache_path = Path(self.img_dir if osp.isdir(self.img_dir)
                          else osp.dirname(self.img_dir)) / ".labels_cache.npz"
        key = _cache_key(self.img_paths)
        if cache_path.exists():
            try:
                z = np.load(cache_path, allow_pickle=True)
                if str(z["key"]) == key:
                    if "paths" in z:     # scan may have dropped corrupt images
                        self.img_paths = [str(p) for p in z["paths"]]
                    return (list(z["labels"]), list(z["segments"]), z["shapes"])
            except Exception:
                pass
        # header-only verification; a process pool from 512 images on (below
        # that the pool's start costs more than it saves)
        if len(self.img_paths) >= 512:
            from multiprocessing import get_context
            with get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
                results = pool.map(check_image, self.img_paths)
        else:
            results = [check_image(p) for p in self.img_paths]
        keep, shapes = [], []
        n_corrupt = 0
        for pth, shape, msg in results:
            if shape is None:
                n_corrupt += 1
                LOGGER.warning(msg)
                continue
            if msg:
                LOGGER.warning(msg)
            keep.append(pth)
            shapes.append(shape)
        if n_corrupt:
            LOGGER.warning(f"scan: dropped {n_corrupt} corrupt images")
        if not keep:
            raise FileNotFoundError(f"no readable images under {self.img_dir}")
        self.img_paths = keep
        labels, segments = [], []
        for pth in self.img_paths:
            lb, seg = self._parse_label_file(img2label_path(pth))
            labels.append(lb)
            segments.append(seg)
        shapes = np.array(shapes, dtype=np.float64)
        try:
            np.savez(cache_path, key=key,
                     paths=np.array(self.img_paths),
                     labels=np.array(labels, dtype=object),
                     segments=np.array(segments, dtype=object), shapes=shapes)
        except OSError:
            LOGGER.warning(f"could not write label cache at {cache_path}")
        return labels, segments, shapes

    @staticmethod
    def _parse_label_file(lb_path: str):
        """YOLO txt -> ((n,5) cls+xywh normalized, list of (k,2) polygon segments)."""
        if not osp.exists(lb_path):
            return np.zeros((0, 5), np.float32), []
        with open(lb_path) as f:
            rows = [ln.split() for ln in f.read().strip().splitlines() if ln]
        if not rows:
            return np.zeros((0, 5), np.float32), []
        segments = []
        labels = []
        for r in rows:
            vals = np.array(r, dtype=np.float32)
            if len(vals) > 5:  # polygon: cls x1 y1 x2 y2 ...
                seg = vals[1:].reshape(-1, 2)
                segments.append(seg)
                box = np.array([seg[:, 0].min(), seg[:, 1].min(),
                                seg[:, 0].max(), seg[:, 1].max()])
                xywh = np.array([(box[0] + box[2]) / 2, (box[1] + box[3]) / 2,
                                 box[2] - box[0], box[3] - box[1]], np.float32)
                labels.append(np.concatenate([[vals[0]], xywh]))
            else:
                labels.append(vals[:5])
        lb = np.stack(labels).astype(np.float32)
        lb[:, 1:] = lb[:, 1:].clip(0, 1)
        _, idx = np.unique(lb, axis=0, return_index=True)   # duplicate rows
        if len(idx) < len(lb):
            lb = lb[idx]
            if segments:
                segments = [segments[x] for x in idx]
        return lb, segments

    def _sort_rect(self, batch_size):
        """Aspect-ratio sorted rect batches and their shapes."""
        s = self.shapes
        ar = s[:, 1] / s[:, 0]
        irect = ar.argsort()
        self.img_paths = [self.img_paths[i] for i in irect]
        self.labels = [self.labels[i] for i in irect]
        self.segments = [self.segments[i] for i in irect]
        self.shapes = s[irect]
        ar = ar[irect]
        nb = self.batch_indices[-1] + 1
        shapes = [[1, 1]] * nb
        for i in range(nb):
            ari = ar[self.batch_indices == i]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes[i] = [maxi, 1]
            elif mini > 1:
                shapes[i] = [1, 1 / mini]
        self.batch_shapes = (np.ceil(
            np.array(shapes) * self.img_size / self.stride + self.pad
        ).astype(np.int64) * self.stride)
        # rect_bucket rounds the shapes up to a multiple of it (fewer distinct
        # shapes, wider pad bands); 0 keeps the stride-granular shapes
        if self.rect_bucket:
            self.batch_shapes = (-(-self.batch_shapes // self.rect_bucket)
                                 * self.rect_bucket)

    def __len__(self):
        return len(self.img_paths)

    # ---------- sample pipeline ----------

    def load_image(self, index, force_load_size=None):
        """cv2 read + max-side resize -> (img, (h0, w0), (h, w))."""
        import cv2
        path = self.img_paths[index]
        im = cv2.imread(path)
        if im is None:
            raise FileNotFoundError(f"Image Not Found {path}")
        h0, w0 = im.shape[:2]
        r = (force_load_size or self.img_size) / max(h0, w0)
        if r != 1:
            interp = cv2.INTER_AREA if (r < 1 and not self.augment) else cv2.INTER_LINEAR
            im = cv2.resize(im, (int(w0 * r), int(h0 * r)), interpolation=interp)
        return im, (h0, w0), im.shape[:2]

    def get_sample(self, index: int, rng: np.random.Generator):
        """-> (img BGR HWC uint8, labels (n,5) cls + normalized xywh, shapes).

        The val branch only; rng is the loader's per-sample generator, which
        the train-time augmentations will draw from."""
        if self.augment:
            raise NotImplementedError(
                "train-time augmentation (mosaic, mixup, affine, HSV) comes with "
                "the trainer (ROADMAP Queue 1 item 5)")
        hyp = self.hyp
        img, (h0, w0), (h, w) = self.load_image(index, hyp.get("test_load_size"))
        shape = (self.batch_shapes[self.batch_indices[index]]
                 if self.rect else self.img_size)
        img, ratio, pad = letterbox(
            img, shape, auto=False, scaleup=False,
            return_int=bool(hyp.get("letterbox_return_int", False)))
        shapes = ((h0, w0), ((h * ratio / h0, w * ratio / w0), pad))
        labels = self.labels[index].copy()
        if labels.size:
            ws_, hs_ = w * ratio, h * ratio
            boxes = np.copy(labels[:, 1:])
            boxes[:, 0] = ws_ * (labels[:, 1] - labels[:, 3] / 2) + pad[0]
            boxes[:, 1] = hs_ * (labels[:, 2] - labels[:, 4] / 2) + pad[1]
            boxes[:, 2] = ws_ * (labels[:, 1] + labels[:, 3] / 2) + pad[0]
            boxes[:, 3] = hs_ * (labels[:, 2] + labels[:, 4] / 2) + pad[1]
            labels[:, 1:] = boxes

        if len(labels):
            h, w = img.shape[:2]
            labels[:, [1, 3]] = labels[:, [1, 3]].clip(0, w - 1e-3)
            labels[:, [2, 4]] = labels[:, [2, 4]].clip(0, h - 1e-3)
            boxes = np.copy(labels[:, 1:])
            boxes[:, 0] = ((labels[:, 1] + labels[:, 3]) / 2) / w
            boxes[:, 1] = ((labels[:, 2] + labels[:, 4]) / 2) / h
            boxes[:, 2] = (labels[:, 3] - labels[:, 1]) / w
            boxes[:, 3] = (labels[:, 4] - labels[:, 2]) / h
            labels[:, 1:] = boxes
        else:
            labels = np.zeros((0, 5), np.float32)
        return np.ascontiguousarray(img), labels.astype(np.float32), shapes

    # ---------- eval-side COCO ground truth ----------

    def image_id(self, index: int):
        stem = Path(self.img_paths[index]).stem
        return int(stem) if stem.isnumeric() else index

    def coco_gt(self) -> Dict:
        """COCO-format GT dict generated from the txt labels."""
        names = self.class_names or [str(i) for i in range(
            1 + max((int(l[:, 0].max()) for l in self.labels if len(l)), default=0))]
        images, annotations = [], []
        ann_id = 0
        for i, pth in enumerate(self.img_paths):
            w, h = self.shapes[i]
            img_id = self.image_id(i)
            images.append(dict(file_name=Path(pth).name, id=img_id,
                               width=int(w), height=int(h)))
            for lb in self.labels[i]:
                c, cx, cy, bw, bh = lb
                x1, y1 = (cx - bw / 2) * w, (cy - bh / 2) * h
                annotations.append(dict(
                    id=ann_id, image_id=img_id, category_id=int(c),
                    bbox=[float(x1), float(y1), float(bw * w), float(bh * h)],
                    area=float(bw * w * bh * h), iscrowd=0, segmentation=[]))
                ann_id += 1
        categories = [dict(id=i, name=n, supercategory="") for i, n in enumerate(names)]
        return dict(images=images, annotations=annotations, categories=categories)
