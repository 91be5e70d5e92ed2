#!/usr/bin/env python3
"""INT8 PTQ CLI (counterpart of tools/quantize.py:22-159).

    python -m mafyolo_tpu_torch.tools.quantize --weights ckpt.npck \
        --data ds.yaml --img-size 640 --batch-size 16 --eval

Folds a checkpoint to deploy form, calibrates the activation amax over
training batches (--calib-method max, or percentile / mse / entropy over a
second histogram pass), optionally finetunes with fake quantization (--qat),
saves the calibrated checkpoint (folded params + amax tree, readable by
either package) and, with --eval, reports val AP for fp, int8-sim
(fake-quant) and int8-real (the int8 conv kernels). --sensitivity instead
quantizes one layer at a time and ranks the layers by AP. Runs on the card
(`--device cpu` for the plain versions on the CPU).
"""
import argparse


def get_args_parser():
    p = argparse.ArgumentParser("MAF-YOLO INT8 PTQ (PyTorch/CUDA)")
    p.add_argument("--weights", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--calib-batches", type=int, default=32)
    p.add_argument("--out", default=None, help="output ckpt (default *_calib.npck)")
    p.add_argument("--eval", action="store_true",
                   help="eval fp vs int8-sim vs int8-real AP")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware finetune after calibration")
    p.add_argument("--qat-epochs", type=int, default=3)
    p.add_argument("--qat-lr", type=float, default=1e-4)
    p.add_argument("--calib-method", default="max",
                   choices=["max", "percentile", "mse", "entropy"])
    p.add_argument("--percentile", type=float, default=99.99)
    p.add_argument("--num-bins", type=int, default=2048)
    p.add_argument("--sensitive-layers-skip", nargs="*", default=None,
                   help="layer-path substrings to leave unquantized")
    p.add_argument("--sensitivity", action="store_true",
                   help="per-layer quantization sensitivity sweep")
    p.add_argument("--sensitivity-out", default="quant_sensitivity.txt")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def run(args, data_dict=None, dataset_cls=None):
    """-> {mode: metrics} with --eval, else {}. data_dict stands in for the
    yaml at args.data and dataset_cls for DetectionDataset (the card's smoke
    passes images held in memory, utils/sample.py:ArrayDataset)."""
    from mafyolo_tpu_torch.core.quant import ptq_calibrate
    from mafyolo_tpu_torch.data.datasets import DetectionDataset
    from mafyolo_tpu_torch.data.loader import create_dataloader
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.reparam import fold_variables
    from mafyolo_tpu_torch.utils.checkpoint import (eval_variables, load_checkpoint,
                                                    save_calibrated)
    from mafyolo_tpu_torch.utils.events import LOGGER, load_yaml

    dataset_cls = dataset_cls or DetectionDataset
    data_dict = data_dict or load_yaml(args.data)
    ckpt = load_checkpoint(args.weights)
    meta = ckpt.get("meta", {})
    graph = meta.get("graph", "maf-yolo-n")
    nc = int(meta.get("nc", data_dict["nc"]))
    variables = eval_variables(ckpt)
    if not ckpt.get("folded", False):
        variables = fold_variables(build_model(graph, nc=nc).specs, variables)
    variables = {"params": variables["params"]}

    def train_loader():
        return create_dataloader(data_dict["train"], args.img_size, args.batch_size,
                                 augment=False, workers=args.workers, shuffle=True,
                                 task="train", dataset_cls=dataset_cls)[0]

    quant_tree = ptq_calibrate(graph, nc, variables, train_loader(),
                               max_batches=args.calib_batches,
                               method=args.calib_method, percentile=args.percentile,
                               num_bins=args.num_bins,
                               skip_layers=args.sensitive_layers_skip, device=args.device)
    if args.sensitivity:
        sensitivity_sweep(args, graph, nc, variables, quant_tree, data_dict, dataset_cls)
        return {}
    if args.qat:
        from mafyolo_tpu_torch.core.quant import qat_finetune
        variables = qat_finetune(graph, nc, variables, quant_tree, train_loader(),
                                 img_size=args.img_size, epochs=args.qat_epochs,
                                 lr=args.qat_lr, device=args.device)
    out = args.out or args.weights.replace(".npck", "_calib.npck").replace(
        ".pt", "_calib.npck")
    save_calibrated(out, variables, quant_tree, meta)
    LOGGER.info(f"calibrated checkpoint -> {out}")

    results = {}
    if args.eval:
        from mafyolo_tpu_torch.core.evaler import Evaler
        from mafyolo_tpu_torch.core.quant import int8_predict_fn, quantized_predict_fn
        modes = [("fp", None), ("int8-sim", quantized_predict_fn)]
        if not args.sensitive_layers_skip:
            # real int8 needs every conv calibrated (mixed precision is a
            # fake-quant concept)
            modes.append(("int8-real", int8_predict_fn))
        for tag, mk in modes:
            evaler = Evaler(data_dict, img_size=args.img_size, batch_size=args.batch_size,
                            workers=args.workers, dataset_cls=dataset_cls,
                            device=args.device)
            loader_v = evaler.init_data()
            evaler.init_model(graph, variables, nc, folded=True)
            if mk is not None:
                evaler._predict = mk(graph, nc, variables, quant_tree,
                                     conf_thres=evaler.conf_thres,
                                     iou_thres=evaler.iou_thres, max_det=evaler.max_det,
                                     device=args.device)
            results[tag] = evaler.eval_model(evaler.predict_model(loader_v))
            LOGGER.info(f"{tag}: AP={results[tag].get('AP', 0):.4f}")
            evaler.report_speed()
    return results


def sensitivity_sweep(args, graph, nc, variables, quant_tree, data_dict, dataset_cls):
    """Quantize ONE layer at a time and record val AP: ranks the layers by
    quantization sensitivity; the lowest-AP layers are the
    --sensitive-layers-skip candidates."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.core.quant import (only_layer_quant, quant_layer_names,
                                              quantized_predict_fn)
    from mafyolo_tpu_torch.utils.events import LOGGER

    layers = quant_layer_names(quant_tree)
    LOGGER.info(f"sensitivity sweep over {len(layers)} quantized layers")
    results = []
    evaler = Evaler(data_dict, img_size=args.img_size, batch_size=args.batch_size,
                    workers=args.workers, dataset_cls=dataset_cls, device=args.device)
    loader_v = evaler.init_data()
    evaler.init_model(graph, variables, nc, folded=True)
    for name in layers:
        evaler._predict = quantized_predict_fn(
            graph, nc, variables, only_layer_quant(quant_tree, name),
            conf_thres=evaler.conf_thres, iou_thres=evaler.iou_thres,
            max_det=evaler.max_det, device=args.device)
        m = evaler.eval_model(evaler.predict_model(loader_v))
        results.append((name, m.get("AP50", 0.0), m.get("AP", 0.0)))
        LOGGER.info(f"quantize only {name}: mAP0.5={results[-1][1]:.4f} "
                    f"mAP0.5:0.95={results[-1][2]:.4f}")
    results.sort(key=lambda r: r[2])
    with open(args.sensitivity_out, "w") as f:
        for name, ap50, ap in results:
            f.write(f"{name} {ap50:.6f} {ap:.6f}\n")
    LOGGER.info(f"sensitivity ranking (most sensitive first) -> {args.sensitivity_out}")


if __name__ == "__main__":
    run(get_args_parser().parse_args())
