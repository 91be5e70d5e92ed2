#!/usr/bin/env python3
"""Eval CLI (counterpart of tools/eval.py:1-114).

    python -m mafyolo_tpu_torch.tools.eval --weights ckpt.npck --data ds.yaml

Evaluates a checkpoint on COCO-style data: folds the re-param blocks to
deploy form, runs letterboxed inference + NMS on the card (`--device cpu`
for the CPU plain versions), reports AP/AP50/AP75/APs/APm/APl.
--reproduce_640_eval applies the per-model letterbox protocol of the
published numbers. Reading and resizing image files needs OpenCV.
"""
import argparse

# per-model 640-eval protocol (N has no named entry in the reference and
# falls through to its default, 638)
EVAL_640_REPRO = {
    "maf-yolo-n": dict(test_load_size=638, letterbox_return_int=True,
                       scale_exact=True, force_no_pad=True, not_infer_on_rect=True),
    "maf-yolo-s": dict(test_load_size=638, letterbox_return_int=True,
                       scale_exact=True, force_no_pad=True, not_infer_on_rect=True),
    "maf-yolo-m": dict(test_load_size=630, letterbox_return_int=True,
                       scale_exact=True, force_no_pad=True, not_infer_on_rect=True),
}


def get_args_parser():
    p = argparse.ArgumentParser("MAF-YOLO evaluation (PyTorch/CUDA)")
    p.add_argument("--weights", required=True, help=".npck checkpoint")
    p.add_argument("--data", default="data/coco.yaml")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--iou-thres", type=float, default=0.65)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--task", default="val", choices=["val", "test", "speed"])
    p.add_argument("--half", type=int, default=1, help="bfloat16 inference")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--reproduce_640_eval", action="store_true")
    p.add_argument("--model-variant", default=None,
                   help="maf-yolo-{n,s,m}; for --reproduce_640_eval defaults")
    p.add_argument("--graph", default=None,
                   help="override the model graph (zoo name or yaml)")
    p.add_argument("--save-json", default=None, help="write predictions json here")
    p.add_argument("--verbose", action="store_true",
                   help="per-class P/R/F1/mAP table (needs --do_pr_metric)")
    p.add_argument("--do_pr_metric", action="store_true",
                   help="precision/recall/F1 at best-F1 confidence")
    p.add_argument("--do_coco_metric", type=int, default=1,
                   help="pycocotools-protocol mAP (default on)")
    p.add_argument("--plot_confusion_matrix", action="store_true")
    p.add_argument("--rect-bucket", type=int, default=0,
                   help="round rect batch shapes up to this multiple (e.g. 64);"
                        " 0 = reference-exact")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def run(args):
    import json

    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
    from mafyolo_tpu_torch.utils.events import LOGGER, load_yaml

    data_dict = load_yaml(args.data)
    ckpt = load_checkpoint(args.weights)
    meta = ckpt.get("meta", {})
    graph = args.graph or meta.get("graph", "maf-yolo-n")
    nc = int(meta.get("nc", data_dict["nc"]))
    variables = eval_variables(ckpt)

    extra = {}
    if args.reproduce_640_eval:
        variant = args.model_variant or (graph if isinstance(graph, str) else None)
        proto = EVAL_640_REPRO.get(variant, EVAL_640_REPRO["maf-yolo-n"])
        extra = dict(test_load_size=proto["test_load_size"],
                     letterbox_return_int=proto["letterbox_return_int"],
                     scale_exact=proto["scale_exact"],
                     force_no_pad=proto["force_no_pad"],
                     rect=not proto["not_infer_on_rect"])
        LOGGER.info(f"reproduce_640_eval protocol: {extra}")

    do_pr = args.do_pr_metric or args.verbose or args.plot_confusion_matrix
    evaler = Evaler(data_dict, img_size=args.img_size, batch_size=args.batch_size,
                    conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                    max_det=args.max_det, task=args.task, half=bool(args.half),
                    workers=args.workers, verbose=args.verbose,
                    do_pr_metric=do_pr, do_coco_metric=bool(args.do_coco_metric),
                    plot_confusion_matrix=args.plot_confusion_matrix,
                    rect_bucket=args.rect_bucket, device=args.device, **extra)
    loader = evaler.init_data()
    evaler.init_model(graph, variables, nc, folded=bool(ckpt.get("folded", False)))
    preds = evaler.predict_model(loader)
    if args.save_json:
        with open(args.save_json, "w") as f:
            json.dump(preds, f)
    if args.task == "speed":
        evaler.report_speed()
        return {}
    metrics = evaler.eval_model(preds)
    evaler.report_speed()
    return metrics


if __name__ == "__main__":
    run(get_args_parser().parse_args())
