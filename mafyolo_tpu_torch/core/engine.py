"""The train-step loop (counterpart of the scheduling in
mafyolo_tpu/core/engine.py:Trainer: solver scaling :79-84, warmup_stepnum
:118-121, train_one_epoch :297-337).

It takes an iterable of (imgs_u8 [B,H,W,3], targets [B,N,5]) batches on the
model's device. The loader, TensorBoard, checkpointing and the repopt,
distill and SimOTA branches are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import runpy
from typing import Dict, Iterable, List

import torch

from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
from mafyolo_tpu_torch.solver.build import build_lr_fn, warmup_schedule


def load_config(path: str) -> Dict:
    """A configs/*.py experiment file (plain Python dicts) -> its sections."""
    ns = runpy.run_path(path)
    return {"model": ns["model"], "solver": ns["solver"]}


class Trainer:
    """The step schedule of one training run: warm-up, gradient accumulation
    and the ATSS -> TAL switch, over a train-form model."""

    def __init__(self, model: torch.nn.Module, cfg: Dict, *, nc: int, img_size: int,
                 batch_size: int, epochs: int, max_stepnum: int,
                 dtype: torch.dtype = torch.float32):
        solver, head = cfg["solver"], cfg["model"]["head"]
        self.solver = solver
        self.batch_size, self.epochs, self.max_stepnum = batch_size, epochs, max_stepnum
        # solver scaling rules (engine.py:79-84), on one card (world size 1)
        accumulate = max(1, round(64 / batch_size))
        self.weight_decay = solver["weight_decay"] * batch_size * accumulate / 64
        self.lr0 = solver["lr0"] * batch_size / 32
        self.lf = build_lr_fn(solver["lr_scheduler"], solver["lrf"], epochs)
        self.warmup_stepnum = max(round(solver["warmup_epochs"] * max_stepnum), 1000) \
            if solver["warmup_epochs"] else 0
        self.warmup_epoch_loss = int(head.get("atss_warmup_epoch", 3))
        self.state = init_train_state(model, weight_decay=self.weight_decay,
                                      lr0=self.lr0, momentum=solver["momentum"])
        self.train_step = make_train_step(
            num_classes=nc, img_size=img_size, strides=tuple(head["strides"]),
            reg_max=head["reg_max"], iou_type=head["iou_type"], dtype=dtype)
        self.last_opt_step = -1

    def plan(self, step: int, epoch: int):
        """-> (schedule dict, do_apply) for step `step` of `epoch`; records an
        apply step (engine.py:305-312)."""
        curr_step = step + self.max_stepnum * epoch
        sched = warmup_schedule(
            curr_step, self.warmup_stepnum, epoch, self.lf, self.lr0,
            self.batch_size, self.solver["warmup_bias_lr"],
            self.solver["warmup_momentum"], self.solver["momentum"])
        do_apply = (curr_step - self.last_opt_step) >= sched["accumulate"]
        if do_apply:
            self.last_opt_step = curr_step
        return sched, do_apply

    def train_one_epoch(self, epoch: int, batches: Iterable, mark=None) -> List[Dict]:
        """Run every batch of `batches` as one train step of `epoch`; returns
        each step's metrics (device tensors: nothing waits for the device).
        mark is passed to the train step (core/train_state.py)."""
        use_atss = epoch < self.warmup_epoch_loss
        metrics = []
        for step, (imgs, targets) in enumerate(batches):
            sched, do_apply = self.plan(step, epoch)
            metrics.append(self.train_step(
                self.state, imgs, targets, sched["lr_bnw"], sched["lr_weight"],
                sched["lr_bias"], sched["momentum"], do_apply, use_atss, mark=mark))
        return metrics
