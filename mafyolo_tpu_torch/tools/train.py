#!/usr/bin/env python3
"""Training CLI (counterpart of tools/train.py:1-119).

    python -m mafyolo_tpu_torch.tools.train --conf configs/maf_yolo_n.py \
        --data data/coco.yaml --img-size 640 --batch-size 32 --epochs 300

Trains on the card (`--device cpu` trains on the CPU with the kernels'
plain versions) and writes runs/train/exp*/: args.yaml, last_ckpt.npck,
best_ckpt.npck and, in the stop-aug tail, best_stop_aug_ckpt.npck, in the
JAX package's checkpoint layout. Reading the dataset yaml needs PyYAML,
and decoding image files needs OpenCV. --quant --calib --pretrained ckpt
runs INT8 PTQ calibration and its eval through tools/quantize.py, as the
JAX CLI does; --quant or --calib alone (QAT through the Trainer), --simota
and --distill are not ported and raise.

Data parallel (parallel/ddp.py), --batch-size the global batch:
--device-count N trains on the first N local devices, N ranks spawned here
(NCCL on the card, gloo with --device cpu; N = 1 runs its one rank in this
process); under torchrun (RANK, WORLD_SIZE, LOCAL_RANK in the environment)
each process is one rank on cuda:LOCAL_RANK:

    torchrun --nproc_per_node 4 -m mafyolo_tpu_torch.tools.train --conf ...
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
    p.add_argument("--quant", action="store_true",
                   help="INT8 flow: with --calib, PTQ of --pretrained")
    p.add_argument("--calib", action="store_true",
                   help="PTQ calibration (with --quant; tools/quantize.py)")
    p.add_argument("--device-count", type=int, default=None,
                   help="data parallel over the first N local devices")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def increment_name(path):
    import glob
    if not osp.exists(path):
        return path
    n = len(glob.glob(path + "*"))
    return f"{path}{n + 1}"


def main(args, data_dict=None, dataset_cls=None):
    """Train as args say. data_dict, if given, stands for the --data yaml and
    dataset_cls for DetectionDataset (utils/sample.py:ArrayDataset serves
    images held in memory); the run's args.yaml is then not written, since
    the data are the caller's."""
    if args.quant and args.calib:
        # PTQ calibrates and evaluates an existing checkpoint, so a trained
        # model is mandatory (tools/train.py:98-110 of the JAX package)
        if not args.pretrained:
            raise SystemExit(
                "--quant --calib requires --pretrained <checkpoint>: "
                "PTQ calibration runs on a trained model (see tools/quantize.py)")
        from mafyolo_tpu_torch.tools import quantize as Q
        return Q.run(Q.get_args_parser().parse_args([
            "--weights", args.pretrained, "--data", args.data_path,
            "--img-size", str(args.img_size), "--batch-size", str(args.batch_size),
            "--eval", "--device", args.device]))
    if args.quant or args.calib:
        raise NotImplementedError("--quant or --calib alone (QAT through the Trainer) "
                                  "is not a feature of the JAX package either: "
                                  "use --quant --calib, or tools/quantize.py --qat")
    if "WORLD_SIZE" in os.environ:               # one rank of torchrun's
        from mafyolo_tpu_torch.parallel import ddp
        rank, _, local_rank = ddp.init_distributed(args.device)
        try:
            device = f"cuda:{local_rank}" if args.device.startswith("cuda") else args.device
            return _run(rank, args, device, data_dict, dataset_cls)
        finally:
            ddp.dist.destroy_process_group()
    if args.device_count is not None:
        from mafyolo_tpu_torch.parallel import ddp
        devices = ddp.check_devices(args.device_count, args.device)
        return ddp.launch(_run_on, args.device_count, args, devices, data_dict, dataset_cls,
                          device=args.device)
    return _run(0, args, args.device, data_dict, dataset_cls)


def _run_on(rank, args, devices, data_dict, dataset_cls):
    return _run(rank, args, devices[rank], data_dict, dataset_cls)


def _run(rank, args, device, data_dict=None, dataset_cls=None):
    """Train as rank `rank` on `device`; in a process group, rank 0 names the
    run's directory for all."""
    import torch

    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.data.datasets import DetectionDataset
    from mafyolo_tpu_torch.parallel import ddp
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.events import LOGGER, load_yaml, save_yaml

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg = Config.fromfile(args.conf_file)
    record = data_dict is None
    data_dict = load_yaml(args.data_path) if record else data_dict
    save_dir = [increment_name(osp.join(args.output_dir, args.name)) if rank == 0 else None]
    if ddp.active():
        ddp.dist.broadcast_object_list(save_dir, 0)
    args.save_dir = save_dir[0]
    if rank == 0:
        os.makedirs(args.save_dir, exist_ok=True)
        if record:
            save_yaml({k: v for k, v in vars(args).items() if not callable(v)},
                      osp.join(args.save_dir, "args.yaml"))
        LOGGER.info(f"save dir: {args.save_dir}")
    return Trainer(args, cfg, data_dict, device=device,
                   dataset_cls=dataset_cls or DetectionDataset).train()


if __name__ == "__main__":
    main(get_args_parser().parse_args())
