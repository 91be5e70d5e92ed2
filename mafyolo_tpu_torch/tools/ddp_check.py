"""Data parallel on the card (parallel/ddp.py): W ranks against one process.

    python -m mafyolo_tpu_torch.tools.ddp_check [--world N] [--backend nccl|gloo]
        [--img 320] [--rank-batch 4] [--steps 10]

Rank r runs on cuda:r over NCCL (the default; --world defaults to every
card), or with --backend gloo every rank shares cuda:0. MAF-YOLO-N in f32,
its weights from a seed, each rank on rows r::W of a global batch of W x
rank-batch images, against one process on the whole batch on cuda:0 (each
run a fresh spawned process):
  * three steps (apply with ATSS, accumulate-only and apply with TAL) with
    cuDNN deterministic and no augmentation: whether the ranks' states are
    equal bit for bit, and each tree's largest error over
    tests/test_multidev_equivalence.py's tolerances (loss, params, EMA and
    BN statistics rtol 1e-5 / atol 1e-6, momentum rtol 1e-4 / atol 2e-5;
    at most 1 passes);
  * one device augmentation of the global batch under the --device-aug
    recipe (configs/maf_yolo_n.py's hyps: mosaic, dynamic mixup, HSV,
    flips): each rank's images and labels equal to the one process's rows
    r::W bit for bit. The plan with that augmentation is run too and its
    errors printed (aug_plan_err_over_tolerance), not checked: with the
    mosaic's many overlapping boxes TAL's targets in f32 turn on near-ties
    that rounding decides (one moved a TAL step's loss by 5e-5 of itself);
    tests/test_torch_ddp.py holds augmented steps in f64;
  * then --steps apply steps with that augmentation, timed.
It prints a JSON line `ddp_check` with the checks, then `ddp_timing`: the
mean ms of the timed steps (CUDA events) on each rank, and the augment
stage of one more step (synchronized), beside one process on one rank's
batch (a rank's work without the collectives) and on the global batch.
The exit code is 1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

NC = 80
PLAN = ((True, True), (False, False), (True, False))
AUG = dict(degrees=0.0, translate=0.1, scale=0.5, shear=0.0, hsv_h=0.015, hsv_s=0.7,
           hsv_v=0.4, fliplr=0.5, flipud=0.0, mosaic=1.0, mixup=0.0, dy_label=5,
           dy_mixup=0.2)
AUG_SEED = 11


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def run_plan(variables, imgs, targets, dev, aug=None):
    """N in f32 on dev from `variables`: PLAN's steps on (imgs, targets),
    this rank's rows inside a process group, with device augmentation `aug`
    (hyps or None) and cuDNN deterministic -> (numpy state, metrics and
    dw_grad launches; the train state and its step, to go on with)."""
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.utils.bridge import (state_dict_to_train_variables,
                                                train_variables_to_state_dict)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model("maf-yolo-n", nc=NC)
    model.load_state_dict(train_variables_to_state_dict(variables))
    model = model.to(dev).to(memory_format=torch.channels_last)
    state = init_train_state(model, weight_decay=5e-4)
    step = make_train_step(num_classes=NC, img_size=imgs.shape[1], device_aug=aug)
    DG.dw_grad.launches = 0
    # cuDNN's deterministic algorithms, so that a run repeats: a weight
    # gradient summed by atomics differs in its last bits from run to run
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        metrics = [{k: float(v) for k, v in step(state, imgs, targets, 0.01, 0.01, 0.01, 0.9,
                                                  do_apply, use_atss).items()}
                   for do_apply, use_atss in PLAN]
        torch.cuda.synchronize(dev)
    finally:
        torch.backends.cudnn.deterministic = was
    names = {id(p): n for n, p in model.named_parameters()}
    mom = {names[id(p)]: st["momentum_buffer"] for p, st in state.optimizer.state.items()}
    out = {"metrics": metrics, "launches": DG.dw_grad.launches, "updates": state.updates,
           "model": state_dict_to_train_variables(model.state_dict()),
           "ema": state_dict_to_train_variables(state.ema.state_dict()),
           "mom": state_dict_to_train_variables(mom)["params"]}
    return out, state, step


def run_steps(variables, imgs, targets, dev, steps: int):
    """run_plan without augmentation (the compared run), then with AUG
    (under "aug_plan"); one augmentation of the batch (AUG, generator
    seeded AUG_SEED) as numpy; then `steps` timed apply steps with AUG
    (mean ms; cuDNN as the caller had it) and one step's augment stage ms."""
    from mafyolo_tpu_torch.data.device_aug import device_augment
    from mafyolo_tpu_torch.parallel import ddp
    imgs, targets = imgs.to(dev), targets.to(dev)
    out, _, _ = run_plan(variables, imgs, targets, dev)
    out["aug_plan"], state, step = run_plan(variables, imgs, targets, dev, AUG)
    augment = ddp.device_augment_shard if ddp.world_size() > 1 else device_augment
    gen = torch.Generator(device=dev).manual_seed(AUG_SEED)
    out["aug"] = tuple(t.cpu().numpy() for t in augment(imgs, targets, gen, **AUG))

    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(steps):
        step(state, imgs, targets, 0.01, 0.01, 0.01, 0.9, True, False)
    t1.record()
    torch.cuda.synchronize(dev)
    out["step_ms"] = t0.elapsed_time(t1) / steps
    stamps = [time.perf_counter()]

    def mark(stage):
        torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())

    step(state, imgs, targets, 0.01, 0.01, 0.01, 0.9, True, False, mark=mark)
    out["augment_ms"] = (stamps[1] - stamps[0]) * 1e3
    return out


def rank_main(rank, out_dir, world, backend, variables, imgs, targets, steps):
    """One rank's run_steps on its rows (cuda:rank under NCCL, else cuda:0),
    pickled to out_dir/rank{rank}.pkl."""
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    res = run_steps(variables, imgs[rank::world], targets[rank::world], dev, steps)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn_runs(world, backend, variables, imgs, targets, steps):
    """run_steps on `world` ranks in a process group (world 1: one process
    outside any group), each a fresh spawned process -> their results."""
    from mafyolo_tpu_torch.parallel import ddp
    with tempfile.TemporaryDirectory() as tmp:
        args = (tmp, world, backend, variables, imgs, targets, steps)
        if world == 1:
            torch.multiprocessing.spawn(rank_main, args=args, nprocs=1, join=True)
        else:
            ddp.launch(rank_main, world, *args, device="cuda", backend=backend,
                       init_method=f"file://{tmp}/rendezvous")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def errors(got, want):
    """-> ({tree_kind: largest |got - want| over its tolerance}, including
    the loss's, {tree_kind: the leaf where it is})."""
    errs = {"loss": max(abs(g[k] - w[k]) / (1e-6 + 1e-5 * abs(w[k]))
                        for g, w in zip(got["metrics"], want["metrics"]) for k in w)}
    worst = {}
    for tree in ("model", "ema", "mom"):
        g, w = dict(_leaves(got[tree])), dict(_leaves(want[tree]))
        for kind in ("params", "batch_stats", "net"):
            keys = [k for k in w if k[0] == kind]
            if keys:
                rtol, atol = (1e-4, 2e-5) if kind == "net" else (1e-5, 1e-6)
                err = {k: float((np.abs(g[k] - w[k]) / (atol + rtol * np.abs(w[k]))).max())
                       for k in keys}
                key = max(err, key=err.get)
                errs[f"{tree}_{kind}"], worst[f"{tree}_{kind}"] = err[key], "/".join(key)
    return errs, worst


def aug_equal(ranks, one) -> bool:
    """Whether every rank's augmented images and labels are the one
    process's rows r::W, bit for bit."""
    w = len(ranks)
    return all(np.array_equal(r["aug"][i], one["aug"][i][k::w])
               for k, r in enumerate(ranks) for i in range(2))


def main(argv=None):
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.parallel import ddp
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    from mafyolo_tpu_torch.utils.sample import train_batch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=None, help="ranks (default: every card)")
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--img", type=int, default=320)
    p.add_argument("--rank-batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ddp_check: needs a CUDA card")
    world = args.world or torch.cuda.device_count()
    if args.backend == "nccl":
        ddp.check_devices(world, "cuda")
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    variables = state_dict_to_train_variables(build_model("maf-yolo-n", nc=NC).state_dict())
    imgs, targets = (t.cpu() for t in train_batch(600, world * args.rank_batch, args.img,
                                                        dev, nc=NC))
    t_run = time.perf_counter()
    ranks = spawn_runs(world, args.backend, variables, imgs, targets, args.steps)
    run_s = time.perf_counter() - t_run
    one = spawn_runs(1, args.backend, variables, imgs, targets, args.steps)[0]
    one_rank_batch = spawn_runs(1, args.backend, variables, imgs[:args.rank_batch],
                                targets[:args.rank_batch], args.steps)[0]
    same = all(np.array_equal(a, b) for r in ranks[1:] for tree in ("model", "ema", "mom")
               for (_, a), (_, b) in zip(_leaves(ranks[0][tree]), _leaves(r[tree])))
    errs, worst = errors(ranks[0], one)
    aug_same = aug_equal(ranks, one)
    aug_errs, _ = errors(ranks[0]["aug_plan"], one["aug_plan"])
    ok = (same and aug_same and all(v <= 1.0 for v in errs.values())
          and all(r["launches"] == one["launches"] > 0 for r in ranks)
          and all(r["updates"] == 2 for r in ranks))
    print(json.dumps({"ddp_check": "ok" if ok else "FAIL", "world": world,
                      "backend": args.backend, "img": args.img, "rank_batch": args.rank_batch,
                      "device_aug": AUG, "ranks_bit_equal": same, "aug_rows_bit_equal": aug_same,
                      "err_over_tolerance": errs, "worst_leaf": worst,
                      "aug_plan_err_over_tolerance": aug_errs,
                      "losses": {"rank0": [m["loss"] for m in ranks[0]["metrics"]],
                                 "one_process": [m["loss"] for m in one["metrics"]]},
                      "aug_plan_losses": {
                          "rank0": [m["loss"] for m in ranks[0]["aug_plan"]["metrics"]],
                          "one_process": [m["loss"] for m in one["aug_plan"]["metrics"]]},
                      "dw_grad_launches": [r["launches"] for r in ranks],
                      "one_process_launches": one["launches"]}), flush=True)
    print(json.dumps({"ddp_timing": {
        "rank_step_ms": [r["step_ms"] for r in ranks],
        "rank_augment_ms": [r["augment_ms"] for r in ranks],
        "one_process_rank_batch_step_ms": one_rank_batch["step_ms"],
        "one_process_rank_batch_augment_ms": one_rank_batch["augment_ms"],
        "one_process_global_batch_step_ms": one["step_ms"],
        "one_process_global_batch_augment_ms": one["augment_ms"],
        "launch_and_run_s": run_s}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
