"""Deploy predict path (counterpart of mafyolo_tpu/core/evaler.py:81-178).

uint8 BGR NHWC images -> fused front-end (layers 0-2, ops/frontend.py) ->
deploy layers 3-33 -> fused decode + greedy NMS (ops/nms.py); a batch whose
H or W is not a multiple of 4 runs the deploy model's own layers 0-2. The
loader, the COCO/PR metrics and the eval CLIs come with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.reparam import fold_variables
from mafyolo_tpu_torch.ops.frontend import (frontend_build, frontend_forward,
                                            frontend_skip_until)
from mafyolo_tpu_torch.ops.nms import fused_decode_nms
from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict


class Evaler:
    """Runs on the card unless the caller names another device
    (`device="cpu"`, as the CPU tests do); without a card the default
    raises at the first tensor that is moved."""

    def __init__(self, conf_thres: float = 0.03, iou_thres: float = 0.65,
                 max_det: int = 300, half: bool = True,
                 scale_exact: bool = False, device="cuda"):
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.half = half
        self.scale_exact = scale_exact
        self.device = torch.device(device)

    # ---------- model ----------

    def init_model(self, graph, variables, nc: int, folded: bool = False):
        """Build the deploy model and pack the front-end kernel's weights.
        variables: the JAX tree layout, numpy leaves; folded deploy
        variables, or with folded=False train-form {'params', 'batch_stats'}
        (e.g. the EMA, utils/bridge.py:state_dict_to_train_variables), which
        models/reparam.py folds first."""
        self.dtype = torch.bfloat16 if self.half else torch.float32
        model = build_model(graph, nc=nc, deploy=True)
        if not folded:
            variables = fold_variables(model.specs, variables)
        self.fe_skip = model.net.skip_until = frontend_skip_until(model.specs, model.save)
        model.load_state_dict(folded_to_state_dict(variables))
        model = model.to(self.device).eval()
        self.fe_weights = (frontend_build(model.net) if self.fe_skip >= 0
                           else None)
        self.model = model.to(dtype=self.dtype,
                              memory_format=torch.channels_last)
        self.nc = nc
        return self.model

    # ---------- prediction ----------

    @torch.no_grad()
    def forward(self, imgs_u8):
        """uint8 BGR NHWC [B,H,W,3] on the evaler's device -> per-level
        (feat, cls, reg) NHWC head outputs in the model dtype.

        Routed by shape, as the JAX predict (evaler.py:117-128): the
        front-end kernel when H and W are multiples of 4, else the full
        deploy model, its own layers 0-2 included."""
        h, w = imgs_u8.shape[1:3]
        if self.fe_skip >= 0 and h % 4 == 0 and w % 4 == 0:
            return self.model(frontend_forward(imgs_u8, self.fe_weights, self.dtype))
        return self.model(imgs_u8.flip(-1).to(self.dtype) / 255.0, skip_until=-1)

    @torch.no_grad()
    def predict(self, imgs_u8):
        """uint8 BGR NHWC images -> dict(boxes [B,max_det,4] xyxy px, scores,
        classes, valid), score-descending per image."""
        if isinstance(imgs_u8, np.ndarray):
            imgs_u8 = torch.from_numpy(imgs_u8)
        outs = self.forward(imgs_u8.to(self.device))
        return fused_decode_nms(
            outs, strides=self.model.strides, reg_max=self.model.reg_max,
            conf_thres=self.conf_thres, iou_thres=self.iou_thres,
            max_det=self.max_det)

    def scale_coords(self, img1_shape, coords, img0_shape, ratio_pad=None):
        """Letterbox-inverse rescale of numpy xyxy boxes, in place
        (evaler.py:382-409, with the scale_exact variant)."""
        if ratio_pad is None:
            gain = [min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])]
            if self.scale_exact:
                gain = [img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1]]
            pad = ((img1_shape[1] - img0_shape[1] * gain[0]) / 2,
                   (img1_shape[0] - img0_shape[0] * gain[0]) / 2)
        else:
            gain = list(np.atleast_1d(ratio_pad[0]))
            pad = ratio_pad[1]
        coords[:, [0, 2]] -= pad[0]
        coords[:, [0, 2]] /= gain[1] if self.scale_exact else gain[0]
        coords[:, [1, 3]] -= pad[1]
        coords[:, [1, 3]] /= gain[0]
        coords[:, [0, 2]] = coords[:, [0, 2]].clip(0, img0_shape[1])
        coords[:, [1, 3]] = coords[:, [1, 3]].clip(0, img0_shape[0])
        return coords
