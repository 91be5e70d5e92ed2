#!/usr/bin/env python3
"""Inference CLI (counterpart of tools/infer.py:1-203).

    python -m mafyolo_tpu_torch.tools.infer --weights ckpt.npck --source img.jpg

Runs a checkpoint on an image, a directory, a video or a webcam, draws the
boxes, saves annotated outputs and optional YOLO-format txt files, reports
FPS. Prediction is the port's Evaler.predict: front-end kernel, deploy
layers, fused decode + greedy NMS (each anchor's best class only, as the JAX
CLI's batched_nms(multi_label=False)) on the card (`--device cpu` for the CPU
plain versions, always in f32 as the JAX CLI on the CPU). Files and cameras
are read and written with OpenCV.
"""
import argparse
import os
import os.path as osp
import time
from collections import deque
from pathlib import Path

VID_FORMATS = (".mp4", ".avi", ".mov", ".mkv")


def get_args_parser():
    p = argparse.ArgumentParser("MAF-YOLO inference (PyTorch/CUDA)")
    p.add_argument("--weights", required=True)
    p.add_argument("--source", required=True,
                   help="image / dir / video path, or a webcam index (e.g. 0)")
    p.add_argument("--webcam-frames", type=int, default=300,
                   help="frames to capture from a webcam source")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.4)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=1000)
    p.add_argument("--classes", type=int, nargs="*", default=None)
    p.add_argument("--save-dir", default="runs/inference/exp")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--half", type=int, default=1)
    p.add_argument("--graph", default=None)
    p.add_argument("--yaml", dest="data_yaml", default=None,
                   help="dataset yaml for class names")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


class CalcFPS:
    def __init__(self, nsamples: int = 50):
        self.framerate = deque(maxlen=nsamples)

    def update(self, v):
        self.framerate.append(v)

    def accumulate(self):
        return sum(self.framerate) / len(self.framerate) if self.framerate else 0.0


def run(args):
    import cv2
    import numpy as np

    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.data.augment import letterbox
    from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
    from mafyolo_tpu_torch.utils.events import LOGGER, load_yaml

    ckpt = load_checkpoint(args.weights)
    meta = ckpt.get("meta", {})
    graph = args.graph or meta.get("graph", "maf-yolo-n")
    nc = int(meta.get("nc", 80))
    names = (load_yaml(args.data_yaml)["names"] if args.data_yaml
             else [str(i) for i in range(nc)])
    evaler = Evaler(conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                    max_det=args.max_det, device=args.device,
                    half=bool(args.half) and args.device != "cpu")
    evaler.init_model(graph, eval_variables(ckpt), nc,
                      folded=bool(ckpt.get("folded", False)))

    webcam = str(args.source).isnumeric()
    src = Path(args.source) if not webcam else None
    if webcam:
        files = []
    elif src.is_dir():
        files = sorted(p for p in src.iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp"))
    else:
        files = [src]
    os.makedirs(args.save_dir, exist_ok=True)
    fps = CalcFPS()
    rng_colors = np.random.default_rng(3)
    colors = rng_colors.integers(64, 255, (max(nc, 1), 3)).tolist()

    def infer_frame(im0, stem):
        img, r, (dw, dh) = letterbox(im0, args.img_size, auto=False)
        t0 = time.perf_counter()
        out = {k: v.cpu() for k, v in evaler.predict(img[None], multi_label=False).items()}
        fps.update(1.0 / max(time.perf_counter() - t0, 1e-9))
        k = int(out["valid"][0].sum())
        boxes = out["boxes"][0][:k].numpy().astype(np.float64)
        scores = out["scores"][0][:k].numpy()
        classes = out["classes"][0][:k].numpy()
        if args.classes is not None and k:
            keep = np.isin(classes, args.classes)
            boxes, scores, classes = boxes[keep], scores[keep], classes[keep]
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - dw) / r
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - dh) / r
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, im0.shape[1])
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, im0.shape[0])
        txt_lines = []
        for b, s, c in zip(boxes, scores, classes):
            x1, y1, x2, y2 = map(int, b)
            cv2.rectangle(im0, (x1, y1), (x2, y2), colors[int(c) % len(colors)], 2)
            cv2.putText(im0, f"{names[int(c)]} {s:.2f}", (x1, max(y1 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                        colors[int(c) % len(colors)], 2)
            if args.save_txt:
                h0, w0 = im0.shape[:2]
                cx, cy = (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0
                bw, bh = (x2 - x1) / w0, (y2 - y1) / h0
                txt_lines.append(f"{int(c)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f} {s:.4f}")
        if args.save_txt and txt_lines:
            Path(args.save_dir, stem + ".txt").write_text("\n".join(txt_lines) + "\n")
        return im0, len(boxes)

    def stream(cap, out_path, stem, limit=None):
        """Annotate every frame of cap into a video at out_path -> frames."""
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             cap.get(cv2.CAP_PROP_FPS) or 30, (w, h))
        n = 0
        try:
            while limit is None or n < limit:
                ok, frame = cap.read()
                if not ok:
                    break
                frame, _ = infer_frame(frame, f"{stem}_{n:06d}")
                vw.write(frame)
                n += 1
        finally:
            cap.release()
            vw.release()
        return n

    if webcam:
        # annotated frames go to save_dir as a video (no display assumed)
        cap = cv2.VideoCapture(int(args.source))
        if not cap.isOpened():
            raise RuntimeError(f"cannot open webcam {args.source}")
        out_path = osp.join(args.save_dir, f"webcam{args.source}_out.mp4")
        n = stream(cap, out_path, "webcam", args.webcam_frames)
        LOGGER.info(f"webcam -> {out_path} ({n} frames, {fps.accumulate():.1f} fps)")
        return

    for f in files:
        if f.suffix.lower() in VID_FORMATS:
            out_path = osp.join(args.save_dir, f.stem + "_out.mp4")
            n = stream(cv2.VideoCapture(str(f)), out_path, f.stem)
            LOGGER.info(f"{f} -> {out_path} ({n} frames, {fps.accumulate():.1f} fps)")
        else:
            im0 = cv2.imread(str(f))
            if im0 is None:
                LOGGER.warning(f"unreadable image {f}")
                continue
            im0, ndet = infer_frame(im0, f.stem)
            out_path = osp.join(args.save_dir, f.name)
            cv2.imwrite(out_path, im0)
            LOGGER.info(f"{f.name}: {ndet} detections -> {out_path} "
                        f"({fps.accumulate():.1f} fps)")


if __name__ == "__main__":
    run(get_args_parser().parse_args())
