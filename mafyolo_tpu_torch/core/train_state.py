"""Training state and the train step (counterpart of
mafyolo_tpu/core/train_state.py:30-220), in PyTorch's idiom.

Params are the module's f32 parameters and `.grad` accumulates across steps;
the nesterov-SGD momentum lives in the optimizer's buffers; the EMA covers
params and BN running stats (utils/ema.py). One step: uint8 BGR images ->
train-form forward (autocast to the compute dtype on the card) -> ATSS or TAL
assignment and the VFL + GIoU + DFL loss in f32 -> backward (the depthwise
dk through ops/dw_grad) -> on an apply step, SGD over the three groups and
the EMA. On an accumulate-only step params, momentum and EMA stay put; the
BN running stats move on every step (train_state.py:181-207). The JAX flat
buffers (core/flatten.py) are a TPU device and have no counterpart here.

With device_aug, the step augments the batch on its device first
(data/device_aug.py), drawing from a generator seeded by (seed, rng_step);
device_augment does the BGR -> RGB flip and the /255 itself.

Loss normalization: by the batch's target_scores_sum, the single-device
large-batch semantics of the JAX step (train_state.py:11-15). Inside a
process group of more than one rank (parallel/ddp.py) the step is one
rank's part of that global-batch step: the ranks' batches make the global
batch, BatchNorm, the loss's normalizer and device augmentation see all of
it, an apply step sums the ranks' gradients, and the metrics are the global
batch's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from mafyolo_tpu_torch.data.device_aug import aug_seed, device_augment
from mafyolo_tpu_torch.models.losses import detection_loss
from mafyolo_tpu_torch.parallel import ddp
from mafyolo_tpu_torch.solver.build import GROUP_BIAS, GROUP_BNW, GROUP_WEIGHT, build_optimizer
from mafyolo_tpu_torch.utils.ema import ModelEMA


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.SGD
    ema: ModelEMA
    updates: int = 0       # optimizer steps taken
    rng_step: int = 0      # train steps taken


def init_train_state(model: torch.nn.Module, *, weight_decay: float,
                     lr0: float = 0.01, momentum: float = 0.937,
                     ema_decay: float = 0.9999) -> TrainState:
    """Optimizer and EMA for a train-form model (already on its device, in
    f32, channels_last on the card). The EMA starts as a copy of the state."""
    return TrainState(model=model,
                      optimizer=build_optimizer(model, lr0, momentum, weight_decay),
                      ema=ModelEMA(model, ema_decay))


def make_train_step(*, num_classes: int, img_size: int,
                    strides: Sequence[int] = (8, 16, 32), reg_max: int = 16,
                    iou_type: str = "giou", dtype: torch.dtype = torch.float32,
                    device_aug: Optional[Dict] = None, seed: int = 0):
    """-> step(state, imgs_u8, targets, lr_bnw, lr_w, lr_b, momentum,
    do_apply, use_atss, mark=None) -> metrics (loss and its components,
    detached tensors on the device; nothing waits for the device).

    imgs_u8 [B,H,W,3] uint8 BGR and targets [B,N,5] on the model's device.
    dtype is the compute dtype: bf16 runs the forward under autocast, f32
    runs it plain (the images take the model's parameter dtype, as JAX's
    take model.dtype). device_aug, if given, is device_augment's hyps (the
    Trainer's `device_aug` dict). mark(stage), if given, is called after
    each stage ("augment" with device_aug, "forward", "loss", "backward",
    "optimizer") for timing. Inside a process group of more than one rank,
    imgs_u8 and targets are this rank's rows of the global batch
    (parallel/ddp.py), every rank calls the step with the same schedule, and
    the state stays equal on all of them."""

    def step(state: TrainState, imgs_u8, targets, lr_bnw: float, lr_w: float,
             lr_b: float, momentum: float, do_apply: bool, use_atss: bool,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        dev = imgs_u8.device.type
        data_parallel = ddp.world_size() > 1
        if device_aug is not None:
            gen = torch.Generator(device=imgs_u8.device)
            gen.manual_seed(aug_seed(seed, state.rng_step))
            augment = ddp.device_augment_shard if data_parallel else device_augment
            imgs, targets = augment(imgs_u8, targets, gen, **device_aug)
            if mark:
                mark("augment")
        else:
            # BGR uint8 -> RGB float in [0, 1]
            imgs = imgs_u8.flip(-1).float() / 255.0
        imgs = imgs.to(next(model.parameters()).dtype)
        with torch.autocast(dev, dtype=dtype, enabled=dtype != torch.float32):
            outs = model(imgs)
        if mark:
            mark("forward")
        loss, comps = detection_loss(
            outs, targets, use_atss=use_atss, num_classes=num_classes,
            img_size=img_size, strides=strides, reg_max=reg_max,
            iou_type=iou_type)
        if mark:
            mark("loss")
        loss.backward()
        if mark:
            mark("backward")
        if do_apply:
            if data_parallel:
                ddp.all_reduce_grads(model.parameters())
            opt = state.optimizer
            for gid, lr in ((GROUP_BNW, lr_bnw), (GROUP_WEIGHT, lr_w), (GROUP_BIAS, lr_b)):
                opt.param_groups[gid]["lr"] = lr
                opt.param_groups[gid]["momentum"] = momentum
            opt.step()
            opt.zero_grad(set_to_none=True)
            state.updates += 1
            state.ema.update(model, state.updates)
        state.rng_step += 1
        if mark:
            mark("optimizer")
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in comps.items()}}
        if data_parallel:
            total = ddp.all_reduce_sum(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, total.unbind()))
        return metrics

    return step
