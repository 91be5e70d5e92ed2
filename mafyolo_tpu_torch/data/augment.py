"""Val-time letterbox (counterpart of mafyolo_tpu/data/augment.py:22-47).

Images are BGR uint8 HWC. `cv2` is imported only when the image has to be
resized; the border is written with numpy, bit-equal to
`cv2.copyMakeBorder(..., BORDER_CONSTANT)`, so an image whose long side
already has the target size needs no OpenCV (the card's machine has none).
The train-time augmentations (HSV, affine, mosaic, mixup, copy-paste) come
with the trainer.
"""
from __future__ import annotations

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
