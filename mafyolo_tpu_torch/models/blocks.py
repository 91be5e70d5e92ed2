"""MAF-YOLO blocks as torch modules (NCHW, run channels_last), deploy and
train forms.

Counterpart of mafyolo_tpu/models/blocks.py. Every re-parameterizable block
exists in two forms, chosen by `deploy`: the train form (multi-branch
conv + BN) and the deploy form (one biased conv); models/reparam.py maps one
onto the other. Module and attribute names equal the JAX parameter tree's
keys, so both trees map onto `state_dict()` one leaf to one tensor
(utils/bridge.py).

Train-form numerics follow the JAX package: BatchNorm with flax semantics
(momentum 0.97 on the running stats, eps 1e-3, biased batch variance, stats
in f32), every stride-1 depthwise conv through ops/dwconv.dw_conv, and the
head's train outputs in f32. Under autocast the convs run in bf16 while the
parameters stay f32, like the JAX model's compute dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mafyolo_tpu_torch.ops.dwconv import dw_conv

# Branch schedule of the UniRepLKNet dilated-reparam block for each origin
# kernel size: (kernel, dilation) pairs; a copy of blocks.py:580-589.
DILATED_BRANCHES = {
    17: ((5, 1), (9, 2), (3, 4), (3, 5), (3, 7)),
    15: ((5, 1), (7, 2), (3, 3), (3, 5), (3, 7)),
    13: ((5, 1), (7, 2), (3, 3), (3, 4), (3, 5)),
    11: ((5, 1), (5, 2), (3, 3), (3, 4), (3, 5)),
    9: ((7, 1), (5, 1), (3, 1)),
    7: ((5, 1), (3, 1)),
    5: ((3, 1), (1, 1)),
    3: ((3, 1), (1, 1)),
}


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


class BatchNorm(nn.Module):
    """BatchNorm2d with flax semantics (blocks.py:175-178).

    Train mode normalizes with the batch statistics and updates
    ra = 0.97 * ra + 0.03 * batch with the BIASED batch variance
    (torch.nn.BatchNorm2d uses the unbiased one). The statistics come from
    the same fused batch_norm call, in f32 whatever the input dtype."""

    def __init__(self, ch: int, momentum: float = 0.97, eps: float = 1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # momentum 1 makes batch_norm write the batch mean and the unbiased
        # batch variance into these two buffers
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=(1 - self.momentum) * (n - 1) / n)
        return y


class DWConv(nn.Module):
    """Bias-free stride-1 depthwise conv through ops/dwconv.dw_conv; weight
    [C,1,k,k] like nn.Conv2d's (blocks.py:_DWConvNoBias)."""

    def __init__(self, ch: int, k: int, pad: int, dilation: int = 1):
        super().__init__()
        self.pad, self.dilation = pad, dilation
        self.weight = nn.Parameter(torch.empty(ch, 1, k, k))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        return dw_conv(x, self.weight, self.pad, self.dilation)


class ConvBN(nn.Module):
    """conv(bias=False) + BatchNorm + optional activation (blocks.py:136-179).
    Its stride-1 depthwise case takes DWConv (blocks.py:150-155)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1, act: Optional[str] = None,
                 pad: Optional[int] = None, dilation: int = 1):
        super().__init__()
        self.act = act
        p = autopad(k, dilation) if pad is None else pad
        # a 1x1 unpadded strided conv reads every stride-th pixel: subsample,
        # then a stride-1 conv (the CPU backward of torch's strided 1x1 conv
        # on channels_last input corrupts the heap when run multithreaded)
        self.subsample = stride if (k == 1 and p == 0) else 1
        if groups > 1 and groups == cin == cout and stride == 1:
            self.conv = DWConv(cout, k, p, dilation)
        else:
            self.conv = nn.Conv2d(cin, cout, k, stride // self.subsample, p,
                                  dilation=dilation, groups=groups, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        if self.subsample > 1:
            x = x[:, :, ::self.subsample, ::self.subsample]
        return _activate(self.bn(self.conv(x)), self.act)


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


def _convish(deploy: bool):
    return ConvAct if deploy else ConvBN


class RepVGGBlock(nn.Module):
    """RepVGG block (blocks.py:511-550). Deploy: relu(conv3x3 + bias).
    Train: relu(dense3x3_bn(x) + pw1x1_bn(x) [+ idbn(x) if cin == cout and
    stride == 1])."""

    def __init__(self, cin: int, cout: int, stride: int = 1, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.fused = ConvAct(cin, cout, 3, stride)
            return
        self.dense = ConvBN(cin, cout, 3, stride)
        self.pw = ConvBN(cin, cout, 1, stride, pad=0)
        if cin == cout and stride == 1:
            self.idbn = BatchNorm(cin)

    def forward(self, x):
        if self.deploy:
            return F.relu(self.fused(x))
        y = self.dense(x) + self.pw(x)
        if hasattr(self, "idbn"):
            y = y + self.idbn(x)
        return F.relu(y)


class ConvWrapper(nn.Module):
    """conv-BN-SiLU, default k3 (the MAFPN down-branch convs)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 deploy: bool = False):
        super().__init__()
        self.block = _convish(deploy)(cin, cout, k, stride, act="silu")

    def forward(self, x):
        return self.block(x)


def max_pool_same(x, k: int, stride: int = 1):
    """MaxPool2d(k, stride, padding=k//2); pads with -inf like flax."""
    return F.max_pool2d(x, k, stride, k // 2)


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast."""

    def __init__(self, cin: int, cout: int, k: int = 5, deploy: bool = False):
        super().__init__()
        c_ = cin // 2
        self.k = k
        cv = _convish(deploy)
        self.cv1 = cv(cin, c_, 1, act="silu")
        self.cv2 = cv(4 * c_, cout, 1, act="silu")

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(x, self.k)
        y2 = max_pool_same(y1, self.k)
        y3 = max_pool_same(y2, self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class MPRep(nn.Module):
    """Dual-path downsample: maxpool2 + 1x1 || stride-2 RepVGG, concat."""

    def __init__(self, cin: int, cout: int, deploy: bool = False):
        super().__init__()
        c_ = cout // 2
        self.pool_proj = _convish(deploy)(cin, c_, 1, act="silu")
        self.rep_down = RepVGGBlock(cin, c_, stride=2, deploy=deploy)

    def forward(self, x):
        a = self.pool_proj(F.max_pool2d(x, 2, 2))
        return torch.cat([a, self.rep_down(x)], 1)


class DilatedReparamBlock(nn.Module):
    """Train form of the UniRepLKNet dilated re-param DW block
    (blocks.py:592-616): bn(dw_kxk(x)) + sum_i bn_i(dw_{k_i,r_i}(x))."""

    def __init__(self, ch: int, k: int):
        super().__init__()
        self.k = k
        self.origin = ConvBN(ch, ch, k, groups=ch)
        for ks, r in DILATED_BRANCHES[k]:
            self.add_module(f"dil_k{ks}_r{r}", ConvBN(ch, ch, ks, groups=ch, dilation=r))

    def forward(self, x):
        out = self.origin(x)
        for ks, r in DILATED_BRANCHES[self.k]:
            out = out + getattr(self, f"dil_k{ks}_r{r}")(x)
        return out


class UniRepLKNetBlock(nn.Module):
    """Deploy: one biased depthwise kxk conv. Train: DilatedReparamBlock +
    post_bn (blocks.py:619-641)."""

    def __init__(self, ch: int, k: int, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.fused = ConvAct(ch, ch, k, groups=ch)
        else:
            self.drb = DilatedReparamBlock(ch, k)
            self.post_bn = BatchNorm(ch)

    def forward(self, x):
        if self.deploy:
            return self.fused(x)
        return self.post_bn(self.drb(x))


class DepthBottleneckUni(nn.Module):
    """1x1 expand -> depthwise k -> SiLU -> 1x1 project (no residual)."""

    def __init__(self, cin: int, cout: int, kersize: int = 5,
                 expansion_depth: float = 1.0, deploy: bool = False):
        super().__init__()
        mid = int(cin * expansion_depth)
        cv = _convish(deploy)
        self.expand = cv(cin, mid, 1, act="silu")
        self.dw = UniRepLKNetBlock(mid, kersize, deploy=deploy)
        self.project = cv(mid, cout, 1, act="silu")

    def forward(self, x):
        return self.project(F.silu(self.dw(self.expand(x))))


class RepHDW(nn.Module):
    """CSP heterogeneous-DW block: 1x1 in, split, `depth` bottlenecks chained
    on the SECOND half, concat [a, b, y0..], 1x1 out."""

    def __init__(self, cin: int, cout: int, depth: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 kersize: int = 5, depth_expansion: float = 1.0,
                 deploy: bool = False):
        super().__init__()
        del shortcut   # the reference stores it but never adds a residual
        self.c_ = int(cout * expansion)
        self.depth = depth
        cv = _convish(deploy)
        self.cv_in = cv(cin, 2 * self.c_, 1, act="silu")
        for i in range(depth):
            self.add_module(f"m{i}", DepthBottleneckUni(
                self.c_, self.c_, kersize, depth_expansion, deploy=deploy))
        self.cv_out = cv((depth + 2) * self.c_, cout, 1, act="silu")

    def forward(self, x):
        x = self.cv_in(x)
        outs = [x[:, :self.c_], x[:, self.c_:]]
        for i in range(self.depth):
            outs.append(getattr(self, f"m{i}")(outs[-1]))
        return self.cv_out(torch.cat(outs, 1))


class Head_DepthUni(nn.Module):
    """Per-level decoupled head -> (stem feat, sigmoid(cls), raw DFL reg).

    Deploy form: cls scores come out in the model dtype. Train form: cls and
    reg come out in f32 (the VFL loss runs in f32), and the preds start at
    zero weights with the prior biases (blocks.py:753-769)."""

    def __init__(self, cin: int, cout: int, reg_max: int = 16,
                 kersize: int = 5, nc: int = 80, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        cv = _convish(deploy)
        self.stem = cv(cin, cout, 1, act="silu")
        self.cls_dw = UniRepLKNetBlock(cout, kersize, deploy=deploy)
        self.cls_proj = cv(cout, cout, 1, act="silu")
        self.cls_pred = nn.Conv2d(cout, nc, 1)
        self.reg_dw = UniRepLKNetBlock(cout, kersize, deploy=deploy)
        self.reg_proj = cv(cout, cout, 1, act="silu")
        self.reg_pred = nn.Conv2d(cout, 4 * (reg_max + 1), 1)
        if not deploy:
            prior = 1e-2
            nn.init.zeros_(self.cls_pred.weight)
            nn.init.constant_(self.cls_pred.bias, -math.log((1 - prior) / prior))
            nn.init.zeros_(self.reg_pred.weight)
            nn.init.constant_(self.reg_pred.bias, 1.0)

    def forward(self, x):
        x = self.stem(x)
        cls = self.cls_pred(self.cls_proj(self.cls_dw(x)))
        reg = self.reg_pred(self.reg_proj(self.reg_dw(x)))
        if self.deploy:
            return x, torch.sigmoid(cls), reg
        return x, torch.sigmoid(cls.float()), reg.float()


def upsample2x(x):
    """nn.Upsample(scale=2, mode='nearest'): exact integer repeat."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
