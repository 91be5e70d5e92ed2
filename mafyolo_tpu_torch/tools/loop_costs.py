"""What the eval loop's CUDA graphs and the train step's device augmentation
cost on the card, beyond their kernels.

    python -m mafyolo_tpu_torch.tools.loop_costs eval [--images 5000] [--batch 64]
    python -m mafyolo_tpu_torch.tools.loop_costs device_aug [--iters 20]

eval: MAF-YOLO-N and -M (random_deploy weights) through Evaler.predict_model
as the Trainer's per-epoch eval runs it (rect batches, stride-granular
shapes, bf16, up to 64 images a batch, a fresh Evaler each eval) over
`--images` images held in memory (utils/sample.py:ArrayDataset) whose sizes
follow VAL_SIZES, a stand-in for COCO val2017's mix of aspect ratios. Each
model runs three evals: eager (Evaler.predict_eager, which also pays
cuDNN's first plans for every shape), then two through the graphs (the
second as the next epoch's eval, which captures again). A JSON line each:
the batches and distinct batch shapes, img/s, infer + NMS ms an image, the
peak of memory_reserved and of memory_allocated over what was reserved
before the Evaler was made, what stays reserved once the Evaler is dropped,
and for the graphs the keys captured, their warm-up and capture seconds
and the keys held at the end.

device_aug: data/device_aug.py:device_augment at bs32@640 with the
Trainer's --device-aug settings for MAF-YOLO-N (mosaic on, then off), then
one Trainer step, each by CUDA events; and device_augment under the
profiler (wall and device-busy ms a call, device ops a call, the kernels
with the most device time). Run it from another checkout (a copy of this
file in it) to hold two versions side by side in one call.

Prints one JSON line a measurement, the card's name and power limit first.
Runs on the card; the card is required.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

NC, IMG = 80, 640
# (h, w) at long side IMG and its share of the images: most are 4:3 or 3:2,
# either way up, a few square; the rest spread evenly over TAIL_RATIOS
VAL_SIZES = {(480, 640): 0.40, (427, 640): 0.20, (640, 480): 0.12, (640, 427): 0.08,
             (640, 640): 0.03}
TAIL_RATIOS = np.geomspace(1 / 3, 3, 40)      # h / w of the other 17%


def emit(**kw):
    print(json.dumps(kw), flush=True)


def val_sizes(n, seed=0):
    """n (h, w) sizes drawn from VAL_SIZES and its tail."""
    tail = [(round(IMG * r), IMG) if r < 1 else (IMG, round(IMG / r)) for r in TAIL_RATIOS]
    sizes = list(VAL_SIZES) + tail
    share = list(VAL_SIZES.values())
    p = np.array(share + [(1 - sum(share)) / len(tail)] * len(tail))
    pick = np.random.default_rng(seed).choice(len(sizes), n, p=p / p.sum())
    return [sizes[i] for i in pick]


def val_set(n, seed=0):
    """{"images", "labels"} of n images for ArrayDataset: one textured image
    with labels (utils/sample.py:eval_set) for each distinct size, shared by
    every image of that size."""
    from mafyolo_tpu_torch.utils.sample import eval_set
    sizes = val_sizes(n, seed)
    distinct = sorted(set(sizes))
    one = eval_set(seed, distinct)
    at = {hw: i for i, hw in enumerate(distinct)}
    return {"images": [one["images"][at[hw]] for hw in sizes],
            "labels": [one["labels"][at[hw]] for hw in sizes]}


def eval_costs(name, src, batch, workers, dev):
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, random_deploy
    folded, _ = random_deploy(name, dev)
    data = {"val": src, "nc": NC, "names": [str(c) for c in range(NC)]}
    for run, route in enumerate(("eager", "graph", "graph")):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ev = Evaler(data, img_size=IMG, batch_size=batch, rect=True, half=True,
                    workers=workers, plot_curve=False, dataset_cls=ArrayDataset, device=dev)
        loader = ev.init_data()
        ev.init_model(name, folded, NC, folded=True)
        if route == "eager":
            ev._predict = ev.predict_eager
        shapes = [tuple(int(v) for v in s) for s in ev.dataset.batch_shapes]
        t0 = time.perf_counter()
        ev.predict_model(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, _, infer, post = ev.speed_result
        rec = dict(run=run, route=route, images=int(n), batch=batch, batches=len(shapes),
                   distinct_batch_shapes=len(set(shapes)), wall_s=wall, img_per_s=n / wall,
                   infer_nms_ms_per_image=infer / n, post_ms_per_image=post / n,
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(dev) - base,
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(dev) - base)
        if ev.graphs is not None and route == "graph":
            rec.update(captures=ev.graphs.captures, capture_s=ev.graphs.capture_ms / 1e3,
                       keys_held=len(ev.graphs.keys),
                       pool_bytes_held_keys=sum(kg.pool_bytes for kg in ev.graphs.keys.values()))
        del ev, loader
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rec["reserved_after_drop_bytes"] = torch.cuda.memory_reserved(dev) - base
        emit(phase="eval_costs", model=name, **rec)


def device_aug_costs(dev, iters):
    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.data import device_aug as DA
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, eval_set, train_set
    from mafyolo_tpu_torch.utils.timing import cuda_ms
    with tempfile.TemporaryDirectory() as tmp:
        args = SimpleNamespace(img_size=IMG, batch_size=32, epochs=2, workers=4, seed=0,
                               save_dir=tmp, device_aug=True, tensorboard=False,
                               eval_interval=1)
        data = {"train": train_set(0, 32), "val": eval_set(1, [(IMG, IMG)]), "nc": NC}
        tr = Trainer(args, Config.fromfile("configs/maf_yolo_n.py"), data, device=dev,
                     dataset_cls=ArrayDataset)
        imgs, targets, _ = next(iter(tr.train_loader))
        x, t = torch.from_numpy(imgs).to(dev), torch.from_numpy(targets).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        rec = {}
        for tag, cfg in (("mosaic", tr.device_aug), ("no_mosaic", dict(tr.device_aug,
                                                                       mosaic=0.0))):
            rec[f"device_augment_{tag}_ms"] = cuda_ms(
                lambda: DA.device_augment(x, t, gen, **cfg), iters)
            rec[f"profile_{tag}"] = profile_calls(
                lambda: DA.device_augment(x, t, gen, **cfg), max(iters // 4, 3))
        rec["step_ms"] = cuda_ms(lambda: tr._step(0, 0, (x, t)), max(iters // 4, 3))
    emit(phase="device_aug_costs", batch=32, img=IMG, mosaic=tr.device_aug["mosaic"],
         iters=iters, **rec)


def profile_calls(fn, n, top=12):
    """fn() n times under torch.profiler: per call the wall ms, the device's
    busy ms (the union of its spans), its kernels and copies, and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + b - a
    most = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall / n, "device_busy_ms": busy / 1e3 / n, "device_ops": len(spans) / n,
            "top_us": [[name[:100], us / n] for name, us in most]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("eval", "device_aug"))
    ap.add_argument("--images", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--models", default="maf-yolo-n,maf-yolo-m")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loop_costs: needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit(phase="card", card=smi.stdout.strip(), torch=torch.__version__)
    if a.what == "eval":
        src = val_set(a.images)
        for name in a.models.split(","):
            eval_costs(name, src, a.batch, a.workers, dev)
    else:
        device_aug_costs(dev, a.iters)


if __name__ == "__main__":
    main()
