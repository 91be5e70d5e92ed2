"""Exponential moving average of the model state (counterpart of
mafyolo_tpu/utils/ema.py and core/train_state.py:188-195).

d = decay * (1 - exp(-updates / 2000)) ramps with the optimizer-step count;
the average covers every float entry of the state dict, params AND BN
running stats, and moves only on optimizer steps.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


class ModelEMA:
    def __init__(self, model: torch.nn.Module, decay: float = 0.9999):
        self.decay = decay
        self.state = {k: v.detach().clone() for k, v in model.state_dict().items()
                      if v.dtype.is_floating_point}

    @torch.no_grad()
    def update(self, model: torch.nn.Module, updates: int) -> None:
        """One EMA step; updates is the already-incremented optimizer-step count."""
        d = self.decay * (1.0 - math.exp(-updates / 2000.0))
        cur = model.state_dict()
        keys = list(self.state)
        ema = [self.state[k] for k in keys]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, [cur[k].detach() for k in keys], alpha=1.0 - d)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.state)
