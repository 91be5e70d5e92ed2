#!/usr/bin/env python3
"""Deployment export (counterpart of tools/export.py:25-104).

    python -m mafyolo_tpu_torch.tools.export --weights ckpt.npck \
        --img-size 640 --batch-size 1 [--end2end] [--quant none|sim|int8]

Folds a checkpoint to deploy form and exports, with torch.export, the one
function the JAX CLI traces: uint8 BGR NHWC images in, the flip to RGB and
/255 in f32, the deploy forward, decode_eval, and with --end2end batched_nms
(its greedy NMS the op `mafyolo::greedy_nms`). --quant sim exports the
fake-quant graph of a calibrated checkpoint (tools/quantize.py's output),
--quant int8 the real-int8 one, its convs the ops `mafyolo::int8_conv` and
`mafyolo::int8_dw`. The program is written with torch.export.save to
<out>/mafyolo.pt2; it runs where it was exported (the card unless
`--device cpu`), and its ops launch the port's kernels there.

To run it, register the ops first:

    import torch, mafyolo_tpu_torch.ops
    program = torch.export.load("export/mafyolo.pt2").module()
    dets = program(imgs_u8)      # a dict with --end2end, else [B, A, 5 + nc]

`--format` offers pt2 alone: the JAX CLI's stablehlo and savedmodel are
JAX and TensorFlow artifacts. There is no ONNX export (no onnx package).
Static shapes: the batch and image size are those given.
"""
import argparse


def get_args_parser():
    p = argparse.ArgumentParser("MAF-YOLO export (PyTorch/CUDA)")
    p.add_argument("--weights", required=True)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--format", choices=["pt2"], default="pt2")
    p.add_argument("--end2end", action="store_true",
                   help="include preprocessing + NMS in the exported graph")
    p.add_argument("--conf-thres", type=float, default=0.4)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--out", default="export")
    p.add_argument("--quant", choices=["none", "sim", "int8"], default="none",
                   help="export the quantized graph of a calibrated ckpt "
                        "(tools/quantize.py): 'sim' = fake-quant, 'int8' = real int8 "
                        "convs through the port's kernels")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def deploy_function(graph, nc: int, folded, quant_tree=None, quant: str = "none",
                    end2end: bool = False, conf_thres: float = 0.4, iou_thres: float = 0.45,
                    max_det: int = 300, device="cuda"):
    """The module the export traces (f32, on device): uint8 BGR NHWC ->
    decode_eval's [B, A, 5 + nc], or with end2end batched_nms's dict."""
    import torch
    from torch import nn

    from mafyolo_tpu_torch.core.quant import quant_model
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.detect import decode_eval
    from mafyolo_tpu_torch.ops.nms import batched_nms
    from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict

    if quant == "none":
        model = build_model(graph, nc=nc, deploy=True)
        model.load_state_dict(folded_to_state_dict(folded))
        model = model.to(device, memory_format=torch.channels_last).eval()
    else:
        model = quant_model(graph, nc, folded, quant_tree,
                            mode="fake" if quant == "sim" else "int8", device=device)

    class Deploy(nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model
            # a tensor divisor: a true division on every device
            self.register_buffer("scale", torch.tensor(255.0, device=device),
                                 persistent=False)

        def forward(self, imgs_u8):
            x = imgs_u8.flip(-1).to(torch.float32) / self.scale
            pred = decode_eval(self.model(x), strides=model.strides, reg_max=model.reg_max)
            if end2end:
                return batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                                   max_det=max_det)
            return pred
    return Deploy().eval()


def run(args):
    """Export per args -> the path of the written program."""
    import os

    import torch

    import mafyolo_tpu_torch.ops  # noqa: F401  (registers the mafyolo:: ops)
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.reparam import fold_variables
    from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
    from mafyolo_tpu_torch.utils.events import LOGGER

    ckpt = load_checkpoint(args.weights)
    meta = ckpt.get("meta", {})
    graph = meta.get("graph", "maf-yolo-n")
    nc = int(meta.get("nc", 80))
    variables = eval_variables(ckpt)
    if not ckpt.get("folded", False):
        variables = fold_variables(build_model(graph, nc=nc).specs, variables)
    quant_tree = ckpt.get("quant")
    if args.quant != "none" and quant_tree is None:
        raise SystemExit("--quant needs a calibrated checkpoint "
                         "(tools/quantize.py output with a 'quant' tree)")
    fn = deploy_function(graph, nc, {"params": variables["params"]}, quant_tree, args.quant,
                         args.end2end, args.conf_thres, args.iou_thres, args.max_det,
                         args.device)
    x = torch.zeros((args.batch_size, args.img_size, args.img_size, 3), dtype=torch.uint8,
                    device=args.device)
    with torch.no_grad():
        program = torch.export.export(fn, (x,), strict=False)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "mafyolo.pt2")
    torch.export.save(program, path)
    LOGGER.info(f"torch.export program -> {path}")
    return path


if __name__ == "__main__":
    run(get_args_parser().parse_args())
