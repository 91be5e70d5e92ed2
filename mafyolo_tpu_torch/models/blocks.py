"""Deploy-form MAF-YOLO blocks as torch modules (NCHW, run channels_last).

Counterpart of the deploy branches of mafyolo_tpu/models/blocks.py. Every
re-parameterizable block is already folded to biased convs; the module and
attribute names equal the JAX parameter tree's keys, so the folded tree maps
onto `state_dict()` one leaf to one tensor (utils/bridge.py).
Train forms and the folds come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def autopad(k: int, dilation: int = 1) -> int:
    """'same'-style padding used throughout the reference: (d*(k-1)+1)//2."""
    return (dilation * (k - 1) + 1) // 2


def _activate(x, act: Optional[str]):
    if act is None:
        return x
    if act == "silu":
        return F.silu(x)
    if act == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {act!r}")


class ConvAct(nn.Module):
    """Biased conv + optional activation (the fold target of conv+BN)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1, act: Optional[str] = None):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(cin, cout, k, stride, autopad(k), groups=groups,
                              bias=True)

    def forward(self, x):
        return _activate(self.conv(x), self.act)


class RepVGGBlock(nn.Module):
    """Deploy RepVGG: relu(conv3x3 + bias)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.fused = ConvAct(cin, cout, 3, stride)

    def forward(self, x):
        return F.relu(self.fused(x))


class ConvWrapper(nn.Module):
    """Deploy conv-SiLU, default k3 (the MAFPN down-branch convs)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.block = ConvAct(cin, cout, k, stride, act="silu")

    def forward(self, x):
        return self.block(x)


def max_pool_same(x, k: int, stride: int = 1):
    """MaxPool2d(k, stride, padding=k//2); pads with -inf like flax."""
    return F.max_pool2d(x, k, stride, k // 2)


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast."""

    def __init__(self, cin: int, cout: int, k: int = 5):
        super().__init__()
        c_ = cin // 2
        self.k = k
        self.cv1 = ConvAct(cin, c_, 1, act="silu")
        self.cv2 = ConvAct(4 * c_, cout, 1, act="silu")

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(x, self.k)
        y2 = max_pool_same(y1, self.k)
        y3 = max_pool_same(y2, self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class MPRep(nn.Module):
    """Dual-path downsample: maxpool2 + 1x1 || stride-2 RepVGG, concat."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        c_ = cout // 2
        self.pool_proj = ConvAct(cin, c_, 1, act="silu")
        self.rep_down = RepVGGBlock(cin, c_, stride=2)

    def forward(self, x):
        a = self.pool_proj(F.max_pool2d(x, 2, 2))
        return torch.cat([a, self.rep_down(x)], 1)


class UniRepLKNetBlock(nn.Module):
    """Deploy UniRepLKNet block: one biased depthwise kxk conv."""

    def __init__(self, ch: int, k: int):
        super().__init__()
        self.fused = ConvAct(ch, ch, k, groups=ch)

    def forward(self, x):
        return self.fused(x)


class DepthBottleneckUni(nn.Module):
    """1x1 expand -> depthwise k -> SiLU -> 1x1 project (no residual)."""

    def __init__(self, cin: int, cout: int, kersize: int = 5,
                 expansion_depth: float = 1.0):
        super().__init__()
        mid = int(cin * expansion_depth)
        self.expand = ConvAct(cin, mid, 1, act="silu")
        self.dw = UniRepLKNetBlock(mid, kersize)
        self.project = ConvAct(mid, cout, 1, act="silu")

    def forward(self, x):
        return self.project(F.silu(self.dw(self.expand(x))))


class RepHDW(nn.Module):
    """CSP heterogeneous-DW block: 1x1 in, split, `depth` bottlenecks chained
    on the SECOND half, concat [a, b, y0..], 1x1 out."""

    def __init__(self, cin: int, cout: int, depth: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 kersize: int = 5, depth_expansion: float = 1.0):
        super().__init__()
        del shortcut   # the reference stores it but never adds a residual
        self.c_ = int(cout * expansion)
        self.depth = depth
        self.cv_in = ConvAct(cin, 2 * self.c_, 1, act="silu")
        for i in range(depth):
            self.add_module(f"m{i}", DepthBottleneckUni(
                self.c_, self.c_, kersize, depth_expansion))
        self.cv_out = ConvAct((depth + 2) * self.c_, cout, 1, act="silu")

    def forward(self, x):
        x = self.cv_in(x)
        outs = [x[:, :self.c_], x[:, self.c_:]]
        for i in range(self.depth):
            outs.append(getattr(self, f"m{i}")(outs[-1]))
        return self.cv_out(torch.cat(outs, 1))


class Head_DepthUni(nn.Module):
    """Per-level decoupled head -> (stem feat, sigmoid(cls), raw DFL reg).

    Deploy form: cls scores come out in the model dtype."""

    def __init__(self, cin: int, cout: int, reg_max: int = 16,
                 kersize: int = 5, nc: int = 80):
        super().__init__()
        self.stem = ConvAct(cin, cout, 1, act="silu")
        self.cls_dw = UniRepLKNetBlock(cout, kersize)
        self.cls_proj = ConvAct(cout, cout, 1, act="silu")
        self.cls_pred = nn.Conv2d(cout, nc, 1)
        self.reg_dw = UniRepLKNetBlock(cout, kersize)
        self.reg_proj = ConvAct(cout, cout, 1, act="silu")
        self.reg_pred = nn.Conv2d(cout, 4 * (reg_max + 1), 1)

    def forward(self, x):
        x = self.stem(x)
        cls = torch.sigmoid(self.cls_pred(self.cls_proj(self.cls_dw(x))))
        reg = self.reg_pred(self.reg_proj(self.reg_dw(x)))
        return x, cls, reg


def upsample2x(x):
    """nn.Upsample(scale=2, mode='nearest'): exact integer repeat."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
