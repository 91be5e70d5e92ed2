"""Eval loop (counterpart of mafyolo_tpu/core/evaler.py:30-375).

Flow: letterbox loader (data/) -> uint8 BGR NHWC batch to the device -> fused
front-end (ops/frontend.py: layers 0-2 of a MAF graph, layers 0-1 of a
YOLOv6 office graph whose layer 0 is a RepVGG block) -> the other deploy
layers -> fused decode + greedy NMS (ops/nms.py) -> host-side rescale to
native image space (scale_coords) -> COCO-format detections -> COCO mAP
(utils/coco_eval.py) and, with do_pr_metric, P/R/F1 (utils/metrics.py). A
batch whose H or W is not a multiple of 4, and a graph that does not start
with the RepVGG 3x3/s2 pair (office L), runs the deploy model's own layers.

On the card a predict is one replay of CUDA graphs captured at the first
call of its input shape and thresholds (core/graphs.py), as the JAX Evaler
jits it; on the CPU it runs eagerly.

speed_result times h2d, infer + NMS and post per batch; on the card each
part ends in torch.cuda.synchronize(), so each time covers its own part.
The loop copies a batch to the device itself (the split's h2d part), and
the predict copies it on into its graph's static input.
"""
from __future__ import annotations

import time
import weakref
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from mafyolo_tpu_torch.core.graphs import PredictGraphs
from mafyolo_tpu_torch.data.datasets import DetectionDataset
from mafyolo_tpu_torch.data.loader import create_dataloader
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.reparam import fold_variables
from mafyolo_tpu_torch.ops.frontend import (frontend_build, frontend_forward,
                                            frontend_skip_until)
from mafyolo_tpu_torch.ops.nms import decode_nms_stages, fused_decode_nms
from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict
from mafyolo_tpu_torch.utils.coco_eval import COCOEvaluator
from mafyolo_tpu_torch.utils.events import LOGGER


def coco80_to_coco91_class():
    """COCO paper 80-class index -> annotation 91-class ids."""
    return [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
            22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
            43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
            62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
            85, 86, 87, 88, 89, 90]


class Evaler:
    """Runs on the card unless the caller names another device
    (`device="cpu"`, as the CPU tests do); without a card the default
    raises at the first tensor that is moved. data_dict may be None for
    predict-only use. dataset_cls builds the dataset of init_data from
    data_dict[task] (utils/sample.py:ArrayDataset takes arrays there)."""

    def __init__(self, data_dict: Optional[Dict] = None, img_size: int = 640,
                 batch_size: int = 32, conf_thres: float = 0.03,
                 iou_thres: float = 0.65, max_det: int = 300, task: str = "val",
                 rect: bool = False, half: bool = True,
                 test_load_size: Optional[int] = None,
                 letterbox_return_int: bool = False, scale_exact: bool = False,
                 force_no_pad: bool = False, workers: int = 8,
                 verbose: bool = False, do_coco_metric: bool = True,
                 do_pr_metric: bool = False, plot_curve: bool = True,
                 plot_confusion_matrix: bool = False, save_dir: str = ".",
                 rect_bucket: int = 0, dataset_cls=DetectionDataset, device="cuda"):
        self.data = data_dict or {}
        self.img_size = img_size
        self.batch_size = batch_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.task = task
        self.rect = rect
        # 0 = stride-granular rect batch shapes; 64 collapses the shape set
        # at the cost of wider pad bands
        self.rect_bucket = rect_bucket
        self.half = half
        self.test_load_size = test_load_size
        self.letterbox_return_int = letterbox_return_int
        self.scale_exact = scale_exact
        self.force_no_pad = force_no_pad
        self.workers = workers
        self.verbose = verbose
        self.do_coco_metric = do_coco_metric
        self.do_pr_metric = do_pr_metric
        self.plot_curve = plot_curve
        self.plot_confusion_matrix = plot_confusion_matrix
        self.save_dir = save_dir
        self.dataset_cls = dataset_cls
        self.device = torch.device(device)
        self.pr_metric_result = (0.0, 0.0)
        self.is_coco = bool(self.data.get("is_coco", False))
        self.ids = coco80_to_coco91_class() if self.is_coco else list(range(10000))
        self.speed_result = np.zeros(4)
        # a predict function of uint8 images that predict_model calls in
        # place of self.predict (the quantize CLI's int8 predicts), as the
        # JAX Evaler's _predict
        self._predict = None
        self.graphs = None

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
        self.fe_weights = (frontend_build(model.net, fuse_l2=self.fe_skip >= 2)
                           if self.fe_skip >= 0 else None)
        self.model = model.to(dtype=self.dtype,
                              memory_format=torch.channels_last)
        self.nc = nc
        # graphs hold the old weights' addresses: a new model gets new graphs.
        # They call the stages through a weak reference, so that the Evaler
        # and its graphs are freed as soon as the Evaler is dropped.
        stages = weakref.WeakMethod(self._stages)
        self.graphs = (PredictGraphs(lambda x, **static: stages()(x, **static), self.device)
                       if self.device.type == "cuda" else None)
        return self.model

    # ---------- data ----------

    def init_data(self, class_names=None):
        task = self.task if self.task in ("train", "val", "test") else "val"
        pad = 0.0 if (self.task == "speed" or self.force_no_pad) else 0.5
        hyp = {}
        if self.test_load_size:
            hyp["test_load_size"] = self.test_load_size
        if self.letterbox_return_int:
            hyp["letterbox_return_int"] = True
        loader, dataset = create_dataloader(
            self.data[task], self.img_size, self.batch_size, stride=32, hyp=hyp,
            augment=False, rect=self.rect, pad=pad, workers=self.workers,
            shuffle=False, class_names=class_names or self.data.get("names"),
            task=task, rect_bucket=self.rect_bucket, dataset_cls=self.dataset_cls)
        self.dataset = dataset
        return loader

    # ---------- prediction ----------

    @torch.no_grad()
    def forward(self, imgs_u8):
        """uint8 BGR NHWC [B,H,W,3] on the evaler's device -> per-level
        (feat, cls, reg) NHWC head outputs in the model dtype.

        Routed by shape, as the JAX predict (evaler.py:117-128): the
        front-end kernel (layers 0..fe_skip) when H and W are multiples of
        4, else the full deploy model, its own first layers included."""
        h, w = imgs_u8.shape[1:3]
        if self.fe_skip >= 0 and h % 4 == 0 and w % 4 == 0:
            return self.model(frontend_forward(imgs_u8, self.fe_weights, self.dtype))
        return self.model(imgs_u8.flip(-1).to(self.dtype) / 255.0, skip_until=-1)

    @torch.no_grad()
    def predict(self, imgs_u8, multi_label: bool = True):
        """uint8 BGR NHWC images (numpy, or a tensor on any device) ->
        dict(boxes [B,max_det,4] xyxy px, scores, classes, valid),
        score-descending per image. multi_label=False keeps only each
        anchor's best class (the inference CLI's NMS).

        On the card: one replay of the CUDA graphs of the key (the images'
        shape and dtype, multi_label, and conf_thres, iou_thres and max_det
        as they are at the call); the first call of a key captures them, as
        jax.jit traces a new shape. On the CPU: predict_eager."""
        if self.graphs is None:
            return self.predict_eager(imgs_u8, multi_label)
        return self.graphs(imgs_u8, multi_label=multi_label, conf_thres=self.conf_thres,
                           iou_thres=self.iou_thres, max_det=self.max_det)

    @torch.no_grad()
    def predict_eager(self, imgs_u8, multi_label: bool = True):
        """The same predict as eager launches, the overflow flag read on the
        host between the NMS stages: the CPU's path, and on the card the
        yardstick of the graphs."""
        if isinstance(imgs_u8, np.ndarray):
            imgs_u8 = torch.from_numpy(imgs_u8)
        outs = self.forward(imgs_u8.to(self.device))
        return fused_decode_nms(
            outs, strides=self.model.strides, reg_max=self.model.reg_max,
            conf_thres=self.conf_thres, iou_thres=self.iou_thres,
            max_det=self.max_det, multi_label=multi_label)

    def _stages(self, x, multi_label, conf_thres, iou_thres, max_det):
        """The predict of device images x as decode_nms_stages gives it."""
        return decode_nms_stages(
            self.forward(x), strides=self.model.strides, reg_max=self.model.reg_max,
            conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
            multi_label=multi_label)

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

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict_model(self, loader) -> List[Dict]:
        """Timed prediction loop -> COCO-format detection dicts.

        With do_pr_metric: per-image TP matching at IoU 0.5:0.95 in native
        image space, accumulated into self._pr_stats for
        compute_pr_metrics()."""
        pred_results: List[Dict] = []
        self.speed_result = np.zeros(4)
        sample_offset = 0
        iouv = np.linspace(0.5, 0.95, 10)
        self._pr_stats = []
        self._pr_seen = 0
        self.vis_batch = None      # first-batch (det dict, paths) for plotting
        if self.plot_confusion_matrix:
            from mafyolo_tpu_torch.utils.metrics import ConfusionMatrix
            self.confusion_matrix = ConfusionMatrix(nc=self.nc)
        for imgs, targets, shapes in loader:
            n = imgs.shape[0]
            t0 = time.perf_counter()
            imgs_dev = torch.from_numpy(imgs).to(self.device)
            self._sync()
            t1 = time.perf_counter()
            out = (self._predict or self.predict)(imgs_dev)
            self._sync()
            t2 = time.perf_counter()
            boxes = out["boxes"].to("cpu", torch.float64).numpy()
            scores = out["scores"].to("cpu", torch.float64).numpy()
            classes = out["classes"].cpu().numpy()
            valid = out["valid"].cpu().numpy()
            for i in range(n):
                ds_index = sample_offset + i
                k = int(valid[i].sum())
                img_hw = imgs.shape[1:3]
                b = boxes[i, :k].copy()
                if k:
                    self.scale_coords(img_hw, b, shapes[i][0], shapes[i][1])
                if ds_index < 8:
                    # native-space detections of the first images, kept for
                    # val-pred visualization
                    if self.vis_batch is None:
                        self.vis_batch = ([], [])
                    self.vis_batch[0].append(
                        dict(boxes=b, scores=scores[i, :k],
                             classes=classes[i, :k]))
                    self.vis_batch[1].append(self.dataset.img_paths[ds_index])
                if k:
                    image_id = self.dataset.image_id(ds_index)
                    xywh = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], -1)
                    for j in range(k):
                        pred_results.append(dict(
                            image_id=image_id,
                            category_id=self.ids[int(classes[i, j])] if self.is_coco
                            else int(classes[i, j]),
                            bbox=[round(float(v), 3) for v in xywh[j]],
                            score=round(float(scores[i, j]), 5)))
                if self.do_pr_metric:
                    self._accumulate_pr(i, k, b, scores, classes, targets,
                                        img_hw, shapes[i], iouv)
            sample_offset += n
            t3 = time.perf_counter()
            self.speed_result += np.array([n, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                           (t3 - t2) * 1e3])
        return pred_results

    # ---------- metrics ----------

    def _accumulate_pr(self, i, k, b_native, scores, classes, targets, img_hw,
                       shape_i, iouv):
        """Per-image stats tuple (correct, conf, pcls, tcls) in native space."""
        from mafyolo_tpu_torch.utils.metrics import process_batch
        t = np.asarray(targets[i], np.float64)
        t = t[t[:, 0] >= 0]                              # drop pad rows
        nl = len(t)
        tcls = t[:, 0].tolist() if nl else []
        self._pr_seen += 1
        if k == 0:
            if nl:
                self._pr_stats.append((np.zeros((0, len(iouv)), bool),
                                       np.zeros(0), np.zeros(0), tcls))
            return
        predn = np.concatenate(
            [b_native, np.asarray(scores[i, :k])[:, None],
             np.asarray(classes[i, :k], np.float64)[:, None]], -1)
        correct = np.zeros((k, len(iouv)), bool)
        if nl:
            xy, wh = t[:, 1:3], t[:, 3:5]
            tbox = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
            tbox[:, [0, 2]] *= img_hw[1]
            tbox[:, [1, 3]] *= img_hw[0]
            self.scale_coords(img_hw, tbox, shape_i[0], shape_i[1])
            labelsn = np.concatenate([t[:, 0:1], tbox], 1)
            correct = process_batch(predn, labelsn, iouv)
            if self.plot_confusion_matrix:
                self.confusion_matrix.process_batch(predn, labelsn)
        self._pr_stats.append((correct, predn[:, 4], predn[:, 5], tcls))

    def compute_pr_metrics(self, class_names=None) -> Dict[str, float]:
        """P/R/F1/mAP at the best-F1 confidence. Sets self.pr_metric_result =
        (mAP50, mAP50:95)."""
        from mafyolo_tpu_torch.utils.metrics import ap_per_class
        stats = [np.concatenate([np.atleast_1d(np.asarray(x[j])) for x in
                                 self._pr_stats], 0)
                 if self._pr_stats else np.zeros(0)
                 for j in range(4)]
        if not len(stats) or not len(stats[0]) or not stats[0].any():
            LOGGER.info("Calculate metric failed, might check dataset.")
            self.pr_metric_result = (0.0, 0.0)
            return {"P": 0.0, "R": 0.0, "F1": 0.0, "mAP50": 0.0, "mAP": 0.0}
        stats[0] = stats[0].reshape(-1, 10)
        names = class_names or self.data.get("names") or \
            [str(c) for c in range(self.nc)]
        # plot_curve renders PR/F1/P/R curve PNGs into save_dir (none
        # without matplotlib)
        p, r, ap, f1, ap_class = ap_per_class(
            *stats, plot=self.plot_curve, save_dir=self.save_dir, names=names)
        mf1 = f1.mean(0)
        # the LAST argmax of mean F1, as the reference picks it
        best = len(mf1) - mf1[::-1].argmax() - 1
        LOGGER.info(f"IOU 50 best mF1 threshold near {best / 1000.0}.")
        ap50, ap_mean = ap[:, 0], ap.mean(1)
        mp, mr = p[:, best].mean(), r[:, best].mean()
        map50, map_ = ap50.mean(), ap_mean.mean()
        nt = np.bincount(stats[3].astype(np.int64), minlength=self.nc)
        s = ("%-16s" + "%12s" * 7) % ("Class", "Images", "Labels", "P@.5iou",
                                      "R@.5iou", "F1@.5iou", "mAP@.5",
                                      "mAP@.5:.95")
        LOGGER.info(s)
        pf = "%-16s" + "%12i" * 2 + "%12.3g" * 5
        LOGGER.info(pf % ("all", self._pr_seen, nt.sum(), mp, mr, mf1[best],
                          map50, map_))
        if self.verbose and self.nc > 1:
            for ci, c in enumerate(ap_class):
                LOGGER.info(pf % (names[c], self._pr_seen, nt[c], p[ci, best],
                                  r[ci, best], f1[ci, best], ap50[ci],
                                  ap_mean[ci]))
        self.pr_metric_result = (float(map50), float(map_))
        if self.plot_confusion_matrix:
            out = Path(self.save_dir) / "confusion_matrix.csv"
            np.savetxt(out, self.confusion_matrix.matrix, fmt="%d",
                       delimiter=",",
                       header=",".join(list(names) + ["background"]))
            self.confusion_matrix.plot(save_dir=self.save_dir,
                                       names=list(names))
            LOGGER.info(f"confusion matrix -> {out} (+ .png)")
        return {"P": float(mp), "R": float(mr), "F1": float(mf1[best]),
                "mAP50": float(map50), "mAP": float(map_)}

    def eval_model(self, pred_results: List[Dict]) -> Dict[str, float]:
        pr = self.compute_pr_metrics() if self.do_pr_metric else {}
        if not self.do_coco_metric:
            # the PR-metric mAPs stand in for the COCO ones
            return {"AP": pr.get("mAP", 0.0), "AP50": pr.get("mAP50", 0.0), **pr}
        gt = self.dataset.coco_gt()
        if self.is_coco:
            for c in gt["categories"]:
                c["id"] = self.ids[c["id"]]
            for a in gt["annotations"]:
                a["category_id"] = self.ids[a["category_id"]]
        if not pred_results:
            LOGGER.warning("no detections produced; AP = 0")
            return {**pr,
                    **{k: 0.0 for k in ("AP", "AP50", "AP75", "APs", "APm",
                                        "APl")}}
        metrics = COCOEvaluator(gt, pred_results).summarize()
        LOGGER.info("COCO eval: " + ", ".join(f"{k}={v:.4f}"
                                              for k, v in metrics.items()))
        return {**pr, **metrics}

    def report_speed(self):
        n, pre, inf, nms_post = self.speed_result
        if n:
            LOGGER.info(f"speed per image: h2d {pre / n:.2f}ms, "
                        f"infer+nms {inf / n:.2f}ms, post {nms_post / n:.2f}ms")
        return self.speed_result


def run_eval(graph, variables, nc, data_dict, folded=False, on_vis=None,
             **kwargs) -> Dict:
    """One-call eval: the eval CLI's and, with the trainer, each epoch's.

    on_vis: optional callback receiving the annotated first-batch prediction
    images (utils/plots.plot_val_pred)."""
    evaler = Evaler(data_dict, **kwargs)
    loader = evaler.init_data()
    evaler.init_model(graph, variables, nc, folded=folded)
    preds = evaler.predict_model(loader)
    metrics = evaler.eval_model(preds)
    if on_vis is not None and evaler.vis_batch:
        from mafyolo_tpu_torch.utils.plots import plot_val_pred
        on_vis(plot_val_pred(evaler.vis_batch[0], evaler.vis_batch[1],
                             names=data_dict.get("names")))
    evaler.report_speed()
    return metrics
