"""Pure-numpy COCO bbox evaluation, faithful to pycocotools COCOeval
(counterpart of mafyolo_tpu/utils/coco_eval.py:1-215, kept equal to it).

Greedy score-descending matching at 10 IoU thresholds with crowd/ignore
handling, area ranges (all/small/medium/large), maxDets (1/10/100), 101-point
interpolated precision, and the 12 standard summary metrics. Sorts are
stable, so detections of equal score keep their input order.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between det boxes [D,4] and gt boxes [G,4], xywh; IoF for crowd gts."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2) - np.maximum(dx1[:, None], gx1), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2) - np.maximum(dy1[:, None], gy1), 0, None)
    inter = iw * ih
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEvaluator:
    """evaluate(gt_dict, detections) -> the 12 COCO summary metrics.

    gt_dict: COCO-format dict with 'images', 'annotations', 'categories'.
    detections: list of dicts {image_id, category_id, bbox [x,y,w,h], score}.
    """

    def __init__(self, gt: Dict, detections: List[Dict],
                 iou_thrs: np.ndarray = IOU_THRS, max_dets: Sequence[int] = MAX_DETS):
        self.iou_thrs = np.asarray(iou_thrs)
        self.max_dets = tuple(max_dets)
        self.img_ids = [im["id"] for im in gt["images"]]
        self.cat_ids = sorted(c["id"] for c in gt["categories"])
        self._gts = defaultdict(list)
        for ann in gt["annotations"]:
            self._gts[(ann["image_id"], ann["category_id"])].append(ann)
        self._dts = defaultdict(list)
        for det in detections:
            self._dts[(det["image_id"], det["category_id"])].append(det)
        self._iou_cache: Dict = {}
        self.eval = None

    # ---------- per-image matching (pycocotools evaluateImg) ----------

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts_raw = self._gts[(img_id, cat_id)]
        dts_raw = self._dts[(img_id, cat_id)]
        if not gts_raw and not dts_raw:
            return None
        g_ignore_raw = np.array([
            bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0))
            or g["area"] < area_rng[0] or g["area"] > area_rng[1]
            for g in gts_raw], dtype=bool)
        # sort gts: non-ignored first (stable)
        g_order = np.argsort(g_ignore_raw, kind="stable")
        gts = [gts_raw[i] for i in g_order]
        g_ignore = g_ignore_raw[g_order]
        iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
        d_order = np.argsort([-d["score"] for d in dts_raw], kind="stable")[:max_det]
        dts = [dts_raw[i] for i in d_order]

        d_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        # IoUs cached in raw-gt order (area-range independent), permuted per range
        ck = (img_id, cat_id)
        ious_raw = self._iou_cache.get(ck)
        if ious_raw is None:
            g_boxes_raw = np.array([g["bbox"] for g in gts_raw],
                                   np.float64).reshape(-1, 4)
            iscrowd_raw = np.array([bool(g.get("iscrowd", 0)) for g in gts_raw])
            ious_raw = _iou_xywh(d_boxes, g_boxes_raw, iscrowd_raw)
            self._iou_cache[ck] = ious_raw
        ious = ious_raw[:, g_order] if len(gts_raw) else ious_raw

        t_n = len(self.iou_thrs)
        dtm = np.zeros((t_n, len(dts)), np.int64)      # matched gt index + 1
        gtm = np.zeros((t_n, len(gts)), np.int64)
        dt_ig = np.zeros((t_n, len(dts)), bool)
        for ti, t in enumerate(self.iou_thrs):
            for di in range(len(dts)):
                best_iou = min(t, 1 - 1e-10)
                best = -1
                for gi in range(len(gts)):
                    if gtm[ti, gi] and not iscrowd[gi]:
                        continue
                    if best > -1 and not g_ignore[best] and g_ignore[gi]:
                        break  # gts sorted: once into ignored region with a match, stop
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best = gi
                if best == -1:
                    continue
                dt_ig[ti, di] = g_ignore[best]
                dtm[ti, di] = best + 1
                gtm[ti, best] = di + 1
        # unmatched dets outside the area range are ignored
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig = dt_ig | ((dtm == 0) & out_of_rng[None, :])
        return dict(scores=np.array([d["score"] for d in dts]),
                    dtm=dtm, dt_ig=dt_ig, g_ignore=g_ignore)

    # ---------- accumulation (pycocotools accumulate) ----------

    def accumulate(self):
        t_n, r_n = len(self.iou_thrs), len(REC_THRS)
        k_n, a_n, m_n = len(self.cat_ids), len(AREA_RNG), len(self.max_dets)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))
        md_max = max(self.max_dets)
        for ki, cat in enumerate(self.cat_ids):
            for ai, rng in enumerate(AREA_RNG.values()):
                # match once at the largest maxDet; slice per-image columns for the
                # smaller settings (pycocotools evaluateImg/accumulate split)
                full = [self._evaluate_img(img, cat, rng, md_max)
                        for img in self.img_ids]
                full = [r for r in full if r is not None]
                if not full:
                    continue
                for mi, md in enumerate(self.max_dets):
                    results = [dict(scores=r["scores"][:md], dtm=r["dtm"][:, :md],
                                    dt_ig=r["dt_ig"][:, :md], g_ignore=r["g_ignore"])
                               for r in full]
                    scores = np.concatenate([r["scores"] for r in results])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([r["dtm"] for r in results], 1)[:, order]
                    dt_ig = np.concatenate([r["dt_ig"] for r in results], 1)[:, order]
                    npig = int(sum((~r["g_ignore"]).sum() for r in results))
                    if npig == 0:
                        continue
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, 1).astype(np.float64)
                    fp_sum = np.cumsum(fps, 1).astype(np.float64)
                    for ti in range(t_n):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope, then sample at the 101 recall points
                        q = np.zeros(r_n)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.eval = dict(precision=precision, recall=recall)
        return self

    # ---------- summary ----------

    def _summarize(self, ap=True, iou_thr=None, area="all", max_det=100):
        ai = list(AREA_RNG).index(area)
        mi = self.max_dets.index(max_det)
        if ap:
            s = self.eval["precision"][:, :, :, ai, mi]
            if iou_thr is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou_thr))[0]]
        else:
            s = self.eval["recall"][:, :, ai, mi]
            if iou_thr is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou_thr))[0]]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def summarize(self) -> Dict[str, float]:
        if self.eval is None:
            self.accumulate()
        md = self.max_dets[-1]
        return {
            "AP": self._summarize(True, max_det=md),
            "AP50": self._summarize(True, iou_thr=0.5, max_det=md),
            "AP75": self._summarize(True, iou_thr=0.75, max_det=md),
            "APs": self._summarize(True, area="small", max_det=md),
            "APm": self._summarize(True, area="medium", max_det=md),
            "APl": self._summarize(True, area="large", max_det=md),
            "AR1": self._summarize(False, max_det=self.max_dets[0]),
            "AR10": self._summarize(False, max_det=self.max_dets[1]),
            "AR100": self._summarize(False, max_det=md),
            "ARs": self._summarize(False, area="small", max_det=md),
            "ARm": self._summarize(False, area="medium", max_det=md),
            "ARl": self._summarize(False, area="large", max_det=md),
        }


def evaluate_coco(gt: Dict, detections: List[Dict]) -> Dict[str, float]:
    return COCOEvaluator(gt, detections).summarize()
