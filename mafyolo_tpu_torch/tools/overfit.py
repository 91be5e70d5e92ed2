"""MAF-YOLO-N trained to boxes on the card (the JAX package's synthetic
overfit), then its best checkpoint served on every path and scored by AP.

    python -m mafyolo_tpu_torch.tools.overfit [--steps 960] [--out DIR]

The set (utils/sample.py:synth_set, the learnable set of
tests/helpers.py:make_synth_dataset, made in memory from seeds): 256 train
images of 640x640 and 64 held-out val images at long side 640 in the ratios
of SYNTH_VAL_RATIOS, 3 classes, one colour each. train(): the port's Trainer
through its own calls (train_one_epoch, eval_and_save, strip_models) with
configs/maf_yolo_n.py unchanged (ATSS for 3 epochs, then TAL; warm-up; EMA)
at bs32@640 in bf16 with --device-aug, no stop-aug tail (its loader needs
cv2), 8 steps an epoch; the EMA is evaluated on the val set (bf16, rect
batches) every 10 epochs and at the last, best_ckpt and last_ckpt
written and stripped. serve(): the stripped best_ckpt (the EMA) evaluated in
f32 (the reference) and in bf16 (the CUDA graphs: front-end and NMS
kernels) on rect batches; calibrated from the train images by
tools/quantize.py:run, which evaluates fp, int8-sim and int8-real
(core/quant.py:int8_predict_fn: the int8 conv kernels) on square batches;
exported by tools/export.py:run (--end2end, none and int8), each program
evaluated beside the eager function it was traced from. Each path's kernel
launches are read around it.

The JAX package's record of this run on a TPU (docs/STATUS.md: "Training
learns"; 120 epochs of 8 steps, bf16, bs32@640, host mosaic and flips): AP
0.49 at epoch 59, 0.68 at 89, 0.724 (AP50 0.947) at the end; int8 PTQ of
that checkpoint fp AP 0.719 -> int8 0.725.

main() prints a JSON line an eval, then the serving paths' line, the card's
name and power limit first. Runs on the card; the card is required.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from types import SimpleNamespace

import torch

IMG, BATCH = 640, 32
TRAIN_IMAGES, VAL_IMAGES = 256, 64
TRAIN_SEED, VAL_SEED = 0, 1
STEPS = 960                # the JAX run's 120 epochs of 8 steps
EVAL_EVERY = 10            # epochs
CALIB_BATCHES = 4
CONF, IOU = 0.03, 0.65     # the Evaler's, baked into the exported programs
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                      "configs", "maf_yolo_n.py")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def synth_data(img=IMG, n_train=TRAIN_IMAGES, n_val=VAL_IMAGES):
    """The data dict of a run: train and val sets from their seeds."""
    from mafyolo_tpu_torch.utils.sample import SYNTH_COLORS, synth_set, synth_val_sizes
    nc = len(SYNTH_COLORS)
    return {"train": synth_set(TRAIN_SEED, [(img, img)] * n_train),
            "val": synth_set(VAL_SEED, synth_val_sizes(VAL_SEED, n_val, img)),
            "nc": nc, "names": [f"class{c}" for c in range(nc)]}


def launch_counts():
    """The launch counters of the kernels a run and its serving paths take."""
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops import quant_conv as QC
    return {"dw_grad": DG.dw_grad.launches, "frontend": FE.frontend_forward.launches,
            "greedy_nms": G.greedy_nms.launches, "int8_conv": QC.int8_conv.launches,
            "int8_dw": QC.int8_dw.launches, "dw_conv": DD.dw_conv.launches}


def _since(before):
    return {k: v - before[k] for k, v in launch_counts().items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train(steps, save_dir, data=None, device="cuda", graph="maf-yolo-n", img=IMG,
          batch=BATCH, eval_every=EVAL_EVERY, workers=8, on_eval=None, schedule_steps=None):
    """Train `graph` for the first `steps` steps (whole epochs) of a run of
    `schedule_steps` (by default `steps`: the lr schedule and the last eval
    are that run's) on `data` (synth_data's by default) through the port's
    Trainer; on_eval(record) after each eval (epoch, step, mean loss parts
    over the steps since the last eval, the weight lr, AP and AP50 of the
    bf16 EMA eval, train img/s). -> {"curve", "steps", "epochs" (the
    schedule's), "train_s", "wall_s", "dw_sites", "launches" (of the steps
    and of the evals), "best_ap", "best_ckpt", "last_ckpt"}."""
    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, dw_sites

    data = data or synth_data(img)
    cfg = Config.fromfile(CONFIG)
    cfg.model.graph = graph
    per_epoch = -(-len(data["train"]["images"]) // batch)
    schedule_steps = schedule_steps or steps
    if steps % per_epoch or schedule_steps % per_epoch or steps > schedule_steps:
        raise ValueError(f"overfit: {steps} steps of a run of {schedule_steps} is not "
                         f"whole epochs of {per_epoch}")
    epochs = schedule_steps // per_epoch
    args = SimpleNamespace(img_size=img, batch_size=batch, epochs=epochs, workers=workers,
                           seed=0, save_dir=save_dir, device_aug=True, bf16=1,
                           stop_aug_last_n_epoch=0, eval_interval=eval_every,
                           heavy_eval_range=0, save_interval=eval_every, tensorboard=False)
    tr = Trainer(args, cfg, data, device=device, dataset_cls=ArrayDataset)
    n_sites = len(dw_sites(tr.state.model, img, device))

    sums, n_steps = {}, [0]
    step_fn = tr.train_step

    def recorded(*a, **kw):
        met = step_fn(*a, **kw)
        for k, v in met.items():
            sums[k] = sums[k] + v if k in sums else v.clone()
        n_steps[0] += 1
        return met

    tr.train_step = recorded
    curve = []
    launches = {k: dict.fromkeys(launch_counts(), 0) for k in ("steps", "evals")}
    t_start = time.perf_counter()
    train_s = window_s = 0.0
    done = window_images = 0
    for epoch in range(steps // per_epoch):
        before = launch_counts()
        t0 = time.perf_counter()
        tr.train_one_epoch(epoch)
        _sync(device)
        dt = time.perf_counter() - t0
        train_s += dt
        window_s += dt
        window_images += len(data["train"]["images"])
        done += tr.max_stepnum
        for k, v in _since(before).items():
            launches["steps"][k] += v
        before = launch_counts()
        t0 = time.perf_counter()
        metrics = tr.eval_and_save(epoch)
        _sync(device)
        for k, v in _since(before).items():
            launches["evals"][k] += v
        if metrics is None:
            continue
        rec = {"epoch": epoch, "step": done,
               "loss": {k: float(v) / n_steps[0] for k, v in sums.items()},
               "lr_weight": tr.schedule.lrs(tr.max_stepnum - 1, epoch)["lr_weight"],
               "AP": metrics["AP"], "AP50": metrics["AP50"],
               "img_per_s": window_images / window_s, "eval_s": time.perf_counter() - t0,
               "t": time.perf_counter() - t_start}
        curve.append(rec)
        sums.clear()
        n_steps[0] = window_images = 0
        window_s = 0.0
        if on_eval:
            on_eval(rec)
    tr.train_step = step_fn
    tr.strip_models()
    return {"curve": curve, "steps": done, "epochs": epochs, "train_s": train_s,
            "wall_s": time.perf_counter() - t_start, "dw_sites": n_sites,
            "launches": launches, "best_ap": tr.best_ap,
            "best_ckpt": os.path.join(save_dir, "best_ckpt.npck"),
            "last_ckpt": os.path.join(save_dir, "last_ckpt.npck")}


def static_batch(fn, b):
    """fn of a fixed batch b (an exported program) as a function of any batch
    up to b: a short batch is padded with zero images and cut back."""
    def run(x):
        n = x.shape[0]
        if n == b:
            return fn(x)
        out = fn(torch.cat([x, x.new_zeros((b - n, *x.shape[1:]))]))
        return {k: v[:n] for k, v in out.items()}
    return run


def serve(ckpt_path, data, save_dir, device="cuda", img=IMG, batch=BATCH, workers=8,
          calib_batches=CALIB_BATCHES):
    """AP on data["val"] of every serving path of the checkpoint at
    ckpt_path (a Trainer's best_ckpt). -> {"f32", "bf16": run_eval's metrics
    (rect batches); "quant": tools/quantize.py:run's {"fp", "int8-sim",
    "int8-real"} (square batches); "export": {quant: {"program", "eager"}}
    (square batches of `batch`); "launches": each path's; "seconds": each
    path's; "calib_ckpt": the calibrated checkpoint}."""
    import mafyolo_tpu_torch.ops  # noqa: F401  (registers the mafyolo:: ops)
    from mafyolo_tpu_torch.core.evaler import Evaler, run_eval
    from mafyolo_tpu_torch.tools import export as EX
    from mafyolo_tpu_torch.tools import quantize as QT
    from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
    from mafyolo_tpu_torch.utils.sample import ArrayDataset

    ckpt = load_checkpoint(ckpt_path)
    graph, nc = ckpt["meta"]["graph"], int(ckpt["meta"]["nc"])
    out = {"launches": {}, "seconds": {}}
    kw = dict(img_size=img, batch_size=batch, workers=workers, plot_curve=False,
              dataset_cls=ArrayDataset, device=device)

    def timed(tag, fn):
        _sync(device)
        before, t0 = launch_counts(), time.perf_counter()
        res = fn()
        _sync(device)
        out["launches"][tag], out["seconds"][tag] = _since(before), time.perf_counter() - t0
        return res

    for tag, half in (("f32", False), ("bf16", True)):
        out[tag] = timed(tag, lambda: run_eval(graph, eval_variables(ckpt), nc, data,
                                               folded=False, rect=True, half=half, **kw))
    calib = os.path.join(save_dir, "calib.npck")
    argv = ["--weights", ckpt_path, "--data", "in-memory", "--img-size", str(img),
            "--batch-size", str(batch), "--calib-batches", str(calib_batches),
            "--workers", str(workers), "--out", calib, "--eval", "--device", str(device)]
    out["quant"] = timed("quant", lambda: QT.run(QT.get_args_parser().parse_args(argv),
                                                 data_dict=data, dataset_cls=ArrayDataset))
    out["calib_ckpt"] = calib
    calibrated = load_checkpoint(calib)
    out["export"] = {}
    for quant in ("none", "int8"):
        argv = ["--weights", calib, "--img-size", str(img), "--batch-size", str(batch),
                "--end2end", "--conf-thres", str(CONF), "--iou-thres", str(IOU),
                "--quant", quant, "--out", os.path.join(save_dir, f"export_{quant}"),
                "--device", str(device)]
        path = timed(f"export_{quant}", lambda: EX.run(EX.get_args_parser().parse_args(argv)))
        fns = {"program": torch.export.load(path).module(),
               "eager": EX.deploy_function(graph, nc, {"params": calibrated["model"]["params"]},
                                           calibrated["quant"], quant, end2end=True,
                                           conf_thres=CONF, iou_thres=IOU, device=device)}
        res = {}
        for route, fn in fns.items():
            ev = Evaler(data, **kw)
            loader = ev.init_data()
            ev._predict = static_batch(fn, batch)
            with torch.no_grad():
                res[route] = timed(f"export_{quant}_{route}",
                                   lambda: ev.eval_model(ev.predict_model(loader)))
        out["export"][quant] = res
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0].replace("\n", " "))
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"train the first STEPS steps of the {STEPS}-step run")
    ap.add_argument("--out", default=None,
                    help="keep the checkpoints and programs here (default: a temporary "
                         "directory, removed at the end)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("overfit: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit(phase="card", card=smi.stdout.strip(), torch=torch.__version__)
    with tempfile.TemporaryDirectory() as tmp:
        out = a.out or tmp
        os.makedirs(out, exist_ok=True)
        data = synth_data()
        res = train(a.steps, out, data, dev, schedule_steps=STEPS,
                    on_eval=lambda rec: emit(phase="overfit_eval", **rec))
        emit(phase="overfit_train", **{k: v for k, v in res.items() if k != "curve"})
        emit(phase="overfit_serve", **serve(res["best_ckpt"], data, out, dev))


if __name__ == "__main__":
    main()
