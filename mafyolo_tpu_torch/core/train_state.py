"""Training state and the train step (counterpart of
mafyolo_tpu/core/train_state.py:30-220), in PyTorch's idiom.

Params are the module's f32 parameters and `.grad` accumulates across steps;
the nesterov-SGD momentum lives in the optimizer's buffers; the EMA covers
params and BN running stats (utils/ema.py). One step: uint8 BGR images ->
train-form forward (autocast to the compute dtype on the card) -> ATSS or TAL
assignment and the loss in f32 -> backward (the depthwise dk through
ops/dw_grad) -> on an apply step, SGD over the three groups and the EMA. On
an accumulate-only step params, momentum and EMA stay put; the BN running
stats move on every step (train_state.py:181-207). The JAX flat buffers
(core/flatten.py) are a TPU device and have no counterpart here.

The loss (train_state.py:131-163): loss_type "tal" is the VFL + IoU + DFL
loss with ATSS -> TAL assignment (every iou_type; with 'wiou' its running
mean is the state's `wiou_mean`, an f32 tensor that moves on every step,
accumulate-only ones too); "simota" the SimOTA loss of a Head_simota graph;
"distill" the distillation loss against a teacher model, run in eval mode
without gradients on the same images. grad_mask (repopt) multiplies the
accumulated gradient at an apply step, before the weight decay and never
into the stored `.grad` sum (train_state.py:170-176).

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
from mafyolo_tpu_torch.models.losses.distill import distill_detection_loss
from mafyolo_tpu_torch.models.losses.simota import simota_loss
from mafyolo_tpu_torch.models.yolo11 import refuse as refuse_yolo11
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
    # Wise-IoU's running mean (ops/boxes.py:wiou_loss), f32 on the model's
    # device; inert unless iou_type == 'wiou'
    wiou_mean: Optional[torch.Tensor] = None


def init_train_state(model: torch.nn.Module, *, weight_decay: float,
                     lr0: float = 0.01, momentum: float = 0.937,
                     ema_decay: float = 0.9999) -> TrainState:
    """Optimizer and EMA for a train-form model (already on its device, in
    f32, channels_last on the card). The EMA starts as a copy of the state,
    wiou_mean at 1."""
    dev = next(model.parameters()).device
    return TrainState(model=model,
                      optimizer=build_optimizer(model, lr0, momentum, weight_decay),
                      ema=ModelEMA(model, ema_decay),
                      wiou_mean=torch.ones((), dtype=torch.float32, device=dev))


def make_train_step(*, num_classes: int, img_size: int,
                    strides: Sequence[int] = (8, 16, 32), reg_max: int = 16,
                    use_dfl: bool = True, iou_type: str = "giou",
                    loss_weight: Optional[Dict[str, float]] = None,
                    dtype: torch.dtype = torch.float32,
                    device_aug: Optional[Dict] = None, seed: int = 0,
                    loss_type: str = "tal", teacher: Optional[torch.nn.Module] = None,
                    max_epoch: int = 300, distill_feat: bool = False,
                    temperature: float = 20.0,
                    grad_mask: Optional[Dict[str, torch.Tensor]] = None):
    """-> step(state, imgs_u8, targets, lr_bnw, lr_w, lr_b, momentum,
    do_apply, use_atss, epoch_num=0, mark=None) -> metrics (loss and its
    components, detached tensors on the device; nothing waits for the
    device). epoch_num feeds distillation's decay.

    loss_type "tal", "simota" or "distill" (with `teacher`, a train-form
    model on the same device; max_epoch, distill_feat and temperature are
    its loss's); use_dfl, iou_type and loss_weight go to the loss as JAX's
    step passes them (loss_weight to the "tal" loss only). grad_mask maps
    parameter names to repopt's masks (solver/repopt.py) on the model's
    device.

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

    def loss_of(state, outs, imgs, targets, use_atss, epoch_num):
        if loss_type == "simota":
            return simota_loss(outs, targets, num_classes=num_classes, img_size=img_size,
                               strides=strides, iou_type=iou_type)
        if loss_type == "distill":
            return distill_detection_loss(
                outs, teacher_forward(imgs), targets, epoch_num=epoch_num,
                max_epoch=max_epoch, use_atss=use_atss, num_classes=num_classes,
                img_size=img_size, strides=strides, reg_max=reg_max, use_dfl=use_dfl,
                iou_type=iou_type, temperature=temperature, distill_feat=distill_feat)
        return detection_loss(
            outs, targets, use_atss=use_atss, num_classes=num_classes, img_size=img_size,
            strides=strides, reg_max=reg_max, use_dfl=use_dfl, iou_type=iou_type,
            loss_weight=loss_weight, wiou_mean=state.wiou_mean)

    def teacher_forward(imgs):
        # the train form in eval mode (BN running statistics), no gradient,
        # under the student's autocast
        teacher.eval()
        with torch.no_grad(), torch.autocast(imgs.device.type, dtype=dtype,
                                             enabled=dtype != torch.float32):
            return teacher(imgs.to(next(teacher.parameters()).dtype))

    def step(state: TrainState, imgs_u8, targets, lr_bnw: float, lr_w: float,
             lr_b: float, momentum: float, do_apply: bool, use_atss: bool,
             epoch_num=0, mark: Optional[Callable[[str], None]] = None
             ) -> Dict[str, torch.Tensor]:
        refuse_yolo11(getattr(state.model, "specs", ()), "the train step")
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
        loss, comps = loss_of(state, outs, imgs, targets, use_atss, epoch_num)
        comps = dict(comps)
        if "wiou_mean" in comps:
            state.wiou_mean = comps.pop("wiou_mean").detach()
        if mark:
            mark("loss")
        loss.backward()
        if mark:
            mark("backward")
        if do_apply:
            if data_parallel:
                ddp.all_reduce_grads(model.parameters())
            if grad_mask:
                # the optimizer zeroes .grad after it, so the mask meets
                # the accumulated sum once
                for n, p in model.named_parameters():
                    if n in grad_mask:
                        p.grad.mul_(grad_mask[n])
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
