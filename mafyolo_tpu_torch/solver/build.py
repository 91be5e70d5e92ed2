"""Optimizer + LR schedule (counterpart of mafyolo_tpu/solver/build.py).

`group_of`, `build_lr_fn` and `warmup_schedule` are copies of the JAX
package's pure-Python ones. The optimizer is torch.optim.SGD(nesterov=True)
over three param groups, the reference's build_optimizer split: BN gammas
(no decay), conv weights (weight decay), biases incl. BN betas (no decay,
warm-up bias lr). torch SGD computes exactly the JAX update: g = grad +
wd * p; buf = m * buf + g; p -= lr * (g + m * buf).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

GROUP_BNW, GROUP_WEIGHT, GROUP_BIAS = 0, 1, 2


def group_of(path) -> int:
    """Classify a param leaf by its JAX path: BN scale -> bnw, *bias -> bias,
    else weight."""
    keys = [str(getattr(p, "key", p)) for p in path]
    if keys[-1] == "bias":
        return GROUP_BIAS
    if keys[-1] == "scale":  # flax BatchNorm gamma
        return GROUP_BNW
    return GROUP_WEIGHT


def jax_path(name: str, param: torch.Tensor):
    """A torch parameter's name -> its leaf path in the JAX tree (the bridge's
    naming: a 1-d `weight` is a BatchNorm gamma, `scale`)."""
    *path, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if param.ndim == 4 else "scale"
    return (*path, leaf)


def param_groups(model: torch.nn.Module) -> List[List[torch.nn.Parameter]]:
    """[bnw, weight, bias] parameter lists, indexed by the GROUP_* ids."""
    groups: List[List[torch.nn.Parameter]] = [[], [], []]
    for name, p in model.named_parameters():
        groups[group_of(jax_path(name, p))].append(p)
    return groups


def build_optimizer(model: torch.nn.Module, lr0: float, momentum: float,
                    weight_decay: float) -> torch.optim.SGD:
    """SGD-nesterov over the three groups; only the weight group decays. The
    step loop sets each group's lr and momentum before every apply step."""
    bnw, weight, bias = param_groups(model)
    return torch.optim.SGD(
        [{"params": bnw, "weight_decay": 0.0},
         {"params": weight, "weight_decay": weight_decay},
         {"params": bias, "weight_decay": 0.0}],
        lr=lr0, momentum=momentum, nesterov=True)


def build_lr_fn(scheduler: str, lrf: float, epochs: int):
    """Epoch -> lr multiplier (solver/build.py:65-73)."""
    if scheduler == "Cosine":
        return lambda x: ((1 - math.cos(x * math.pi / epochs)) / 2) * (lrf - 1) + 1
    if scheduler == "Constant":
        return lambda x: 1.0
    if scheduler == "linear":
        return lambda x: (1 - x / epochs) * (1.0 - lrf) + lrf
    raise ValueError(f"unknown lr scheduler {scheduler!r}")


def warmup_schedule(curr_step: int, warmup_steps: int, epoch: int, lf, lr0: float,
                    batch_size: int, warmup_bias_lr: float, warmup_momentum: float,
                    momentum: float) -> Dict[str, float]:
    """Per-step host-side schedule (solver/build.py:76-95): lr per group,
    momentum, and the gradient-accumulation length."""
    accumulate = max(1, round(64 / batch_size))
    base = lr0 * lf(epoch)
    if warmup_steps and curr_step <= warmup_steps:
        accumulate = max(1, int(round(float(np.interp(
            curr_step, [0, warmup_steps], [1, 64 / batch_size])))))
        lr_w = float(np.interp(curr_step, [0, warmup_steps], [0.0, base]))
        lr_b = float(np.interp(curr_step, [0, warmup_steps], [warmup_bias_lr, base]))
        mom = float(np.interp(curr_step, [0, warmup_steps],
                              [warmup_momentum, momentum]))
        return dict(lr_bnw=lr_w, lr_weight=lr_w, lr_bias=lr_b, momentum=mom,
                    accumulate=accumulate)
    return dict(lr_bnw=base, lr_weight=base, lr_bias=base, momentum=momentum,
                accumulate=accumulate)
