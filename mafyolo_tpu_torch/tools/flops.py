#!/usr/bin/env python3
"""FLOPs and params report (counterpart of tools/flops.py:20-67).

    python -m mafyolo_tpu_torch.tools.flops --graph maf-yolo-n --img-size 640

Builds the train-form model from its own initialization and, unless
--train-form, folds it to deploy form, then counts one forward of a zero
batch at img-size with torch.utils.flop_counter.FlopCounterMode on the card
(`--device cpu` for the CPU): 2 FLOPs per multiply-add of every conv,
transposed conv and matmul. The JAX CLI reads XLA's cost analysis of the
compiled forward, which also counts elementwise work (activations, BN,
adds, pooling), so its total is somewhat higher than this one; the two
agree on the convolutions. Params: the `params` collection of the JAX tree
(BN statistics left out in the train form), which is the port's
parameters().
"""
import argparse


def model_flops(graph="maf-yolo-n", nc=80, img_size=640, deploy=True, batch=1,
                device="cuda"):
    """-> (FLOPs per image, params) of the deploy (or train) form."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.reparam import fold_variables
    from mafyolo_tpu_torch.utils.bridge import (folded_to_state_dict,
                                                state_dict_to_train_variables)

    model = build_model(graph, nc=nc)
    if deploy:
        folded = fold_variables(model.specs, state_dict_to_train_variables(model.state_dict()))
        model = build_model(graph, nc=nc, deploy=True)
        model.load_state_dict(folded_to_state_dict(folded))
    model = model.to(device).eval()
    params = sum(p.numel() for p in model.parameters())
    x = torch.zeros((batch, img_size, img_size, 3), device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    return counter.get_total_flops() / batch, params


def get_args_parser():
    p = argparse.ArgumentParser("MAF-YOLO flops (PyTorch/CUDA)")
    p.add_argument("--graph", default="maf-yolo-n")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--train-form", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    flops, params = model_flops(args.graph, args.nc, args.img_size,
                                deploy=not args.train_form, device=args.device)
    line = (f"{args.graph} @{args.img_size}: params {params / 1e6:.2f}M, "
            f"flops {flops / 1e9:.2f}G ({'train' if args.train_form else 'deploy'} form)")
    print(line)
    return line


if __name__ == "__main__":
    main()
