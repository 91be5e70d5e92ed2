#!/usr/bin/env python3
"""Training CLI (counterpart of tools/train.py:1-119).

    python -m mafyolo_tpu_torch.tools.train --conf configs/maf_yolo_n.py \
        --data data/coco.yaml --img-size 640 --batch-size 32 --epochs 300

Trains on the card (`--device cpu` trains on the CPU with the kernels'
plain versions) and writes runs/train/exp*/: args.yaml, last_ckpt.npck,
best_ckpt.npck and, in the stop-aug tail, best_stop_aug_ckpt.npck, in the
JAX package's checkpoint layout. Reading the dataset yaml needs PyYAML,
and decoding image files needs OpenCV. --quant/--calib, --simota,
--distill and --device-count are not ported yet and raise.
"""
import argparse
import os
import os.path as osp


def get_args_parser():
    p = argparse.ArgumentParser("MAF-YOLO training (PyTorch/CUDA)")
    p.add_argument("--conf-file", "--conf", dest="conf_file",
                   default="configs/maf_yolo_n.py", help="experiment config .py")
    p.add_argument("--data-path", "--data", dest="data_path",
                   default="data/coco.yaml", help="dataset yaml")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--remat", action="store_true",
                   help="per-block rematerialization (not ported; raises)")
    p.add_argument("--loader-processes", action="store_true",
                   help="decode/augment in a process pool")
    p.add_argument("--output-dir", default="./runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", nargs="?", const=True, default=None)
    p.add_argument("--pretrained", default=None, help="checkpoint for finetune")
    p.add_argument("--eval-interval", type=int, default=20)
    p.add_argument("--heavy-eval-range", type=int, default=50)
    p.add_argument("--stop-aug-last-n-epoch", type=int, default=15)
    p.add_argument("--save-interval", type=int, default=1,
                   help="checkpoint every N epochs (evals/best always save)")
    p.add_argument("--max-labels", type=int, default=120)
    p.add_argument("--bf16", type=int, default=1, help="bf16 autocast on the card")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of steps 2-7 into save_dir/profile")
    p.add_argument("--wandb", action="store_true",
                   help="mirror scalars to wandb (if installed)")
    p.add_argument("--wandb-project", default="mafyolo-tpu")
    p.add_argument("--simota", action="store_true", help="SimOTA loss (not ported)")
    p.add_argument("--distill", action="store_true",
                   help="knowledge distillation (not ported)")
    p.add_argument("--teacher-model-path", default=None)
    p.add_argument("--distill-feat", action="store_true")
    p.add_argument("--temperature", type=float, default=20.0)
    p.add_argument("--device-aug", action="store_true",
                   help="affine/HSV/flip/mosaic/mixup on the device; the host "
                        "loader only letterboxes")
    p.add_argument("--quant", action="store_true", help="INT8 flow (not ported)")
    p.add_argument("--calib", action="store_true",
                   help="PTQ calibration (not ported)")
    p.add_argument("--device-count", type=int, default=None,
                   help="data parallel over N cards (not ported)")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def increment_name(path):
    import glob
    if not osp.exists(path):
        return path
    n = len(glob.glob(path + "*"))
    return f"{path}{n + 1}"


def main(args):
    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.events import LOGGER, load_yaml, save_yaml

    if args.quant or args.calib:
        raise NotImplementedError("--quant/--calib are not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    if args.device_count is not None:
        raise NotImplementedError("--device-count (data parallel) is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    cfg = Config.fromfile(args.conf_file)
    data_dict = load_yaml(args.data_path)
    args.save_dir = increment_name(osp.join(args.output_dir, args.name))
    os.makedirs(args.save_dir, exist_ok=True)
    save_yaml({k: v for k, v in vars(args).items() if not callable(v)},
              osp.join(args.save_dir, "args.yaml"))
    LOGGER.info(f"save dir: {args.save_dir}")
    trainer = Trainer(args, cfg, data_dict, device=args.device)
    return trainer.train()


if __name__ == "__main__":
    main(get_args_parser().parse_args())
