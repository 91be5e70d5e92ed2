"""Depthwise conv with a hand-written backward (counterpart of
mafyolo_tpu/ops/dwconv.py:dw_conv).

  forward  the depthwise conv itself (cuDNN on the card; the JAX forward is
           an XLA conv too);
  dx       the depthwise conv of the cotangent with the spatially flipped
           kernel, padding d*(K-1) - pad (stride 1 only: every DW conv of the
           MAF graphs is stride 1);
  dk       ops/dw_grad.dw_grad: the hand-written kernel on the card, the K^2
           taps on the CPU; accumulated in f32, cast to the kernel's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops.dw_grad import dw_grad


class DWConvFunction(torch.autograd.Function):
    """x [B,C,H,W], kernel [C,1,K,K] -> [B,C,H',W'], stride 1."""

    @staticmethod
    def forward(ctx, x, kernel, pad: int, dilation: int):
        ctx.save_for_backward(x, kernel)
        ctx.pad, ctx.dilation = pad, dilation
        return F.conv2d(x, kernel, padding=pad, dilation=dilation,
                        groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        pad, dilation = ctx.pad, ctx.dilation
        k = kernel.shape[-1]
        # channels_last like the forward's output; the kernel takes no other
        g = g.contiguous(memory_format=torch.channels_last)
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = F.conv2d(g, kernel.flip(2, 3), padding=dilation * (k - 1) - pad,
                          dilation=dilation, groups=x.shape[1])
        if ctx.needs_input_grad[1]:
            dk = dw_grad(x.contiguous(memory_format=torch.channels_last), g,
                         k, pad, dilation).to(kernel.dtype)
        return dx, dk, None, None


def dw_conv(x, kernel, pad: int, dilation: int = 1):
    """Depthwise conv, stride 1, with the hand-written backward. Under autocast
    both operands run in the autocast dtype, as the JAX module casts x and the
    kernel to its compute dtype (blocks.py:_DWConvNoBias)."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        dt = torch.get_autocast_dtype(dev)
        x, kernel = x.to(dt), kernel.to(dt)
        with torch.autocast(dev, enabled=False):
            return DWConvFunction.apply(x, kernel, pad, dilation)
    return DWConvFunction.apply(x, kernel.to(x.dtype), pad, dilation)
