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

Deploy blocks built with quant=True carry the INT8 modes of the JAX
package (mafyolo_tpu/models/blocks.py:182-329): every folded conv is a QuantConv2d and the
maxpool inputs and neck upsample outputs get a QuantAct, each holding its
calibrated activation amax as the buffer `act_amax` (and, while a histogram
is collected, `act_hist`) under the JAX quant tree's path. The mode is an
attribute of those modules, set for a whole model by set_quant_mode:
"calib" (record the running |x| max, and the |x| histogram with bins),
"fake" (fake-quant with a straight-through estimator) or "int8" (real int8
convs through ops/quant_conv.py on weights packed by pack_int8).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mafyolo_tpu_torch.ops import dw_deploy
from mafyolo_tpu_torch.ops import quant_conv as QC
from mafyolo_tpu_torch.ops.dwconv import dw_conv
from mafyolo_tpu_torch.parallel import ddp

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


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """True while a rematerialized block's forward runs again inside the
    backward (models/graph.py). The state a forward updates (BN running
    statistics, a quantizer's calibration max and histogram) keeps what the
    first forward wrote, as nn.remat discards the recompute's mutations."""
    return getattr(_RECOMPUTE, "on", False)


@contextlib.contextmanager
def recompute_context():
    """Marks the recompute of a rematerialized block (thread-local: the
    backward may run on autograd's device thread)."""
    was = recomputing()
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = was


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
    the same fused batch_norm call, in f32 whatever the input dtype.

    Inside a process group of more than one rank (data parallel,
    parallel/ddp.py) they are the global batch's, as flax takes them over a
    sharded batch: each channel's sum and sum of squares (f32 at least) are
    summed over the ranks by an all-reduce that autograd sees, and
    var = E[x^2] - E[x]^2 (flax's own formula), clamped at 0.

    The running statistics move once a forward: a rematerialized block's
    recompute (recomputing()) normalizes alike and leaves them."""

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
        if ddp.world_size() > 1:
            return self._global_forward(x)
        # momentum 1 makes batch_norm write the batch mean and the unbiased
        # batch variance into these two buffers
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        if recomputing():
            return y
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=(1 - self.momentum) * (n - 1) / n)
        return y

    def _global_forward(self, x):
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), xf.numel() // c)])
        total = ddp.all_reduce_sum(local)
        n = total[-1]
        mean = total[:c] / n
        var = (total[c:2 * c] / n - mean * mean).clamp(min=0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        if recomputing():
            return y.to(x.dtype)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return y.to(x.dtype)


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


def fake_quant_sym(x, amax, bits: int = 8):
    """Symmetric fake quantization with a straight-through gradient
    (blocks.py:182-195): scale = max(amax, 1e-12) / qmax, round half to
    even, clip to [-qmax - 1, qmax], dequantize; amax == 0 passes x through.
    The forward is x + (q - x), one rounding away from q, as in JAX. The
    divisors are tensors on x's device, so every division is a true one;
    qmax is filled there, not copied from the host, so a CUDA graph can
    capture it (the int8 predict's QuantAct)."""
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(amax, min=1e-12) / torch.full((), qmax, dtype=amax.dtype,
                                                      device=amax.device)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale
    q = torch.where(amax > 0, q, x)
    return x + (q - x).detach()


def abs_histogram(a, bins: int, amax):
    """jnp.histogram(a, bins, range=(0, max(amax, 1e-12)))[0] of |x| values
    a, as f32 counts. The edges are JAX's linspace, hi * (i / bins) with
    the last edge hi itself; a value lands by searchsorted on them (side
    'right'), a value equal to the last edge in the last bin, and values
    past it in none."""
    hi = torch.clamp(amax.float(), min=1e-12).reshape(1)
    steps = torch.arange(bins, dtype=torch.float32, device=a.device) / hi.new_tensor(bins)
    edges = torch.cat([hi * steps, hi])
    a = a.reshape(-1)
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1].float()


class _Quantizer:
    """The calibration state of a QuantConv2d or QuantAct: `act_amax` (f32
    scalar buffer) and, with hist_bins, `act_hist`."""

    def _init_quant(self, calibrate: bool):
        self.mode = "calib" if calibrate else "fake"
        self.register_buffer("act_amax", torch.zeros(()))

    def set_hist_bins(self, bins: int):
        if bins:
            self.register_buffer("act_hist", torch.zeros(bins, device=self.act_amax.device))
        elif hasattr(self, "act_hist"):
            del self.act_hist

    @torch.no_grad()
    def _observe(self, x):
        """Running max of |x| (f32), then the histogram over [0, new max];
        a recompute (recomputing()) counts nothing."""
        if recomputing():
            return
        a = x.detach().float().abs()
        self.act_amax.copy_(torch.maximum(self.act_amax, a.max()))
        if hasattr(self, "act_hist"):
            self.act_hist += abs_histogram(a, self.act_hist.numel(), self.act_amax)


class QuantAct(_Quantizer, nn.Module):
    """Activation quantizer of a non-conv op (blocks.py:208-235): the
    maxpool inputs of SPPF and MPRep, the neck upsample outputs. "calib"
    records and passes through; "fake" and "int8" fake-quantize in f32."""

    def __init__(self, calibrate: bool = False):
        super().__init__()
        self._init_quant(calibrate)

    def forward(self, x):
        if self.mode == "calib":
            self._observe(x)
            return x
        return fake_quant_sym(x.float(), self.act_amax).to(x.dtype)


class QuantConv2d(_Quantizer, nn.Conv2d):
    """Biased conv with the quant modes of the JAX _RawConv (blocks.py:
    285-329): per-tensor activation amax, per-output-channel weights.
    "calib": record |x|, conv with fake-quant weights; "fake": fake-quant x
    (clip [-128, 127]) and weights, STE; "int8": the real int8 conv of
    ops/quant_conv.py (clip [-127, 127]) on the pack that pack_int8 made.
    `act` is the activation that follows the conv: the int8 kernel applies
    it in its epilogue (ops/quant_conv.py:FUSED_ACTS), the other modes after
    the conv. The pack's tensors are non-persistent buffers `int8_<field>`
    (they move with the module, an exported program holds them as
    constants, and state_dict does not change); `int8` reads the pack."""

    def __init__(self, *args, calibrate: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_quant(calibrate)
        self._int8_fields = None

    def set_int8(self, p: QC.Int8Pack):
        """Hold pack p: its tensors as buffers, its other fields as they are."""
        fields = {}
        for f in dataclasses.fields(p):
            value = getattr(p, f.name)
            if isinstance(value, torch.Tensor):
                self.register_buffer(f"int8_{f.name}", value, persistent=False)
            else:
                fields[f.name] = value
        self._int8_fields = fields

    @property
    def int8(self) -> Optional[QC.Int8Pack]:
        """The packed weights (None before pack_int8)."""
        if self._int8_fields is None:
            return None
        return QC.Int8Pack(**self._int8_fields, **{
            f.name: getattr(self, f"int8_{f.name}") for f in dataclasses.fields(QC.Int8Pack)
            if f.name not in self._int8_fields})

    def forward(self, x, act: Optional[str] = None):
        if self.mode == "int8":
            if self._int8_fields is None:
                raise RuntimeError("int8 mode without packed weights: call pack_int8")
            return QC.int8_conv(x, self.int8, act)
        w = self.weight
        w = fake_quant_sym(w, w.detach().abs().amax((1, 2, 3), keepdim=True))
        if self.mode == "calib":
            self._observe(x)
        else:
            x = fake_quant_sym(x.float(), self.act_amax).to(x.dtype)
        return _activate(F.conv2d(x, w.to(x.dtype), self.bias.to(x.dtype), self.stride,
                                  self.padding, self.dilation, self.groups), act)


def set_quant_mode(model: nn.Module, mode: str, hist_bins: int = 0):
    """Put every quantizer of `model` in `mode` ("calib", "fake" or
    "int8"); with hist_bins the calib modules also collect an |x|
    histogram of that many bins (a fresh zero `act_hist`)."""
    if mode not in ("calib", "fake", "int8"):
        raise ValueError(f"unknown quant mode {mode!r}")
    for m in model.modules():
        if isinstance(m, _Quantizer):
            m.mode = mode
            m.set_hist_bins(hist_bins if mode == "calib" else 0)


def pack_int8(model: nn.Module, device):
    """Quantize and pack every QuantConv2d's weights on the host, from its
    f32 weight, bias and act_amax, onto `device`."""
    for m in model.modules():
        if isinstance(m, QuantConv2d):
            m.set_int8(QC.pack(m.weight, m.bias, m.act_amax, m.stride[0], m.padding[0],
                               m.groups).to(device))


class ConvAct(nn.Module):
    """Biased conv + optional activation (the fold target of conv+BN); with
    quant its conv is a QuantConv2d. A depthwise conv that
    ops/dw_deploy.py:takes_kernel admits (stride 1, odd k <= 9, on the card,
    no autograd) runs as the hand-written kernel with the bias and the
    activation in its epilogue."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1, act: Optional[str] = None, quant: bool = False,
                 calibrate: bool = False):
        super().__init__()
        self.act = act
        if quant:
            self.conv = QuantConv2d(cin, cout, k, stride, autopad(k), groups=groups,
                                    bias=True, calibrate=calibrate)
        else:
            self.conv = nn.Conv2d(cin, cout, k, stride, autopad(k), groups=groups,
                                  bias=True)

    def forward(self, x):
        if isinstance(self.conv, QuantConv2d):
            return self.conv(x, act=self.act)
        if dw_deploy.takes_kernel(self.conv, x):
            return dw_deploy.dw_conv(x, self.conv.weight, self.conv.bias, self.act)
        return _activate(self.conv(x), self.act)


def _convish(deploy: bool, quant: bool = False, calibrate: bool = False):
    if deploy:
        return functools.partial(ConvAct, quant=quant, calibrate=calibrate)
    return ConvBN


class RepVGGBlock(nn.Module):
    """RepVGG block (blocks.py:511-550). Deploy: relu(conv3x3 + bias).
    Train: relu(dense3x3_bn(x) + pw1x1_bn(x) [+ idbn(x) if cin == cout and
    stride == 1]). plain=True keeps the dense branch only: the RealVGG block
    that training_mode='repopt' trains, its structural prior in the
    gradient masks instead (solver/repopt.py)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, deploy: bool = False,
                 plain: bool = False, quant: bool = False, calibrate: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.fused = ConvAct(cin, cout, 3, stride, act="relu", quant=quant,
                                 calibrate=calibrate)
            return
        self.dense = ConvBN(cin, cout, 3, stride)
        if plain:
            return
        self.pw = ConvBN(cin, cout, 1, stride, pad=0)
        if cin == cout and stride == 1:
            self.idbn = BatchNorm(cin)

    def forward(self, x):
        if self.deploy:
            return self.fused(x)
        y = self.dense(x)
        if hasattr(self, "pw"):
            y = y + self.pw(x)
        if hasattr(self, "idbn"):
            y = y + self.idbn(x)
        return F.relu(y)


class Conv(nn.Module):
    """conv-BN-act, default 1x1: SiLU for the Conv row, ReLU for SimConv,
    3x3 SiLU for ConvWrapper, the MAFPN down-branch convs (blocks.py:424-478)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 deploy: bool = False, act: str = "silu", quant: bool = False,
                 calibrate: bool = False):
        super().__init__()
        self.block = _convish(deploy, quant, calibrate)(cin, cout, k, stride, act=act)

    def forward(self, x):
        return self.block(x)


SimConv = functools.partial(Conv, act="relu")
ConvWrapper = functools.partial(Conv, k=3)


def max_pool_same(x, k: int, stride: int = 1):
    """MaxPool2d(k, stride, padding=k//2); pads with -inf like flax."""
    return F.max_pool2d(x, k, stride, k // 2)


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast. With quant, one input quantizer
    `pool_q` is shared by the three pools (blocks.py:500-505)."""

    def __init__(self, cin: int, cout: int, k: int = 5, deploy: bool = False,
                 quant: bool = False, calibrate: bool = False):
        super().__init__()
        c_ = cin // 2
        self.k = k
        cv = _convish(deploy, quant, calibrate)
        self.cv1 = cv(cin, c_, 1, act="silu")
        self.cv2 = cv(4 * c_, cout, 1, act="silu")
        self.pool_q = QuantAct(calibrate) if quant and deploy else nn.Identity()

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(self.pool_q(x), self.k)
        y2 = max_pool_same(self.pool_q(y1), self.k)
        y3 = max_pool_same(self.pool_q(y2), self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class MPRep(nn.Module):
    """Dual-path downsample: maxpool2 + 1x1 || stride-2 RepVGG, concat;
    plain=True takes the RealVGG form of the RepVGG branch."""

    def __init__(self, cin: int, cout: int, deploy: bool = False, plain: bool = False,
                 quant: bool = False, calibrate: bool = False):
        super().__init__()
        c_ = cout // 2
        self.pool_proj = _convish(deploy, quant, calibrate)(cin, c_, 1, act="silu")
        self.rep_down = RepVGGBlock(cin, c_, stride=2, deploy=deploy, plain=plain,
                                    quant=quant, calibrate=calibrate)
        # the pool branch's input quantizer (blocks.py:566-567)
        self.pool_q = QuantAct(calibrate) if quant and deploy else nn.Identity()

    def forward(self, x):
        a = self.pool_proj(F.max_pool2d(self.pool_q(x), 2, 2))
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
    post_bn (blocks.py:619-641). Then `act`, the activation that follows the
    block in the graph: the deploy conv's ConvAct applies it."""

    def __init__(self, ch: int, k: int, deploy: bool = False, quant: bool = False,
                 calibrate: bool = False, act: Optional[str] = None):
        super().__init__()
        self.deploy, self.act = deploy, act
        if deploy:
            self.fused = ConvAct(ch, ch, k, groups=ch, act=act, quant=quant,
                                 calibrate=calibrate)
        else:
            self.drb = DilatedReparamBlock(ch, k)
            self.post_bn = BatchNorm(ch)

    def forward(self, x):
        if self.deploy:
            return self.fused(x)
        return _activate(self.post_bn(self.drb(x)), self.act)


class ReparamLargeKernelConv(nn.Module):
    """Large-kernel depthwise conv + a parallel small-kernel branch, then
    ReLU (blocks.py:644-667). Deploy: relu(one biased DW conv), the ReLU
    its ConvAct's; train: relu(lk_bn(x) + small_bn(x)).
    models/reparam.py:fold_replk folds it."""

    def __init__(self, ch: int, k: int, stride: int = 1, small_k: int = 3,
                 deploy: bool = False, quant: bool = False, calibrate: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.fused = ConvAct(ch, ch, k, stride, groups=ch, act="relu", quant=quant,
                                 calibrate=calibrate)
        else:
            self.lk = ConvBN(ch, ch, k, stride, groups=ch)
            self.small = ConvBN(ch, ch, small_k, stride, groups=ch)

    def forward(self, x):
        if self.deploy:
            return self.fused(x)
        return F.relu(self.lk(x) + self.small(x))


class DepthBottleneckUni(nn.Module):
    """1x1 expand -> depthwise k -> SiLU -> 1x1 project (no residual); the
    SiLU is the depthwise block's `act`."""

    def __init__(self, cin: int, cout: int, kersize: int = 5,
                 expansion_depth: float = 1.0, deploy: bool = False,
                 quant: bool = False, calibrate: bool = False):
        super().__init__()
        mid = int(cin * expansion_depth)
        cv = _convish(deploy, quant, calibrate)
        self.expand = cv(cin, mid, 1, act="silu")
        self.dw = UniRepLKNetBlock(mid, kersize, deploy=deploy, quant=quant,
                                   calibrate=calibrate, act="silu")
        self.project = cv(mid, cout, 1, act="silu")

    def forward(self, x):
        return self.project(self.dw(self.expand(x)))


class RepHDW(nn.Module):
    """CSP heterogeneous-DW block: 1x1 in, split, `depth` bottlenecks chained
    on the SECOND half, concat [a, b, y0..], 1x1 out."""

    def __init__(self, cin: int, cout: int, depth: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 kersize: int = 5, depth_expansion: float = 1.0,
                 deploy: bool = False, quant: bool = False, calibrate: bool = False):
        super().__init__()
        del shortcut   # the reference stores it but never adds a residual
        self.c_ = int(cout * expansion)
        self.depth = depth
        cv = _convish(deploy, quant, calibrate)
        self.cv_in = cv(cin, 2 * self.c_, 1, act="silu")
        for i in range(depth):
            self.add_module(f"m{i}", DepthBottleneckUni(
                self.c_, self.c_, kersize, depth_expansion, deploy=deploy,
                quant=quant, calibrate=calibrate))
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
    zero weights with the prior biases (blocks.py:753-769). The preds stay
    unquantized convs under quant, as in JAX."""

    def __init__(self, cin: int, cout: int, reg_max: int = 16,
                 kersize: int = 5, nc: int = 80, deploy: bool = False,
                 quant: bool = False, calibrate: bool = False):
        super().__init__()
        self.deploy = deploy
        cv = _convish(deploy, quant, calibrate)
        self.stem = cv(cin, cout, 1, act="silu")
        self.cls_dw = UniRepLKNetBlock(cout, kersize, deploy=deploy, quant=quant,
                                       calibrate=calibrate)
        self.cls_proj = cv(cout, cout, 1, act="silu")
        self.cls_pred = nn.Conv2d(cout, nc, 1)
        self.reg_dw = UniRepLKNetBlock(cout, kersize, deploy=deploy, quant=quant,
                                       calibrate=calibrate)
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


class Head_Simota(nn.Module):
    """The YOLOX-style coupled head of the SimOTA path (blocks.py:801-842):
    stem 1x1 -> cls 3x3 -> cls_pred (logits); reg 3x3 -> reg_pred (4 *
    (reg_max + 1) channels: xy offset, log wh) and obj_pred (1, logits).
    cls_pred and obj_pred biases start at the 1e-2 prior, reg_pred's at 0.
    Returns the raw (cls, reg, obj) maps in f32; the sigmoids live in the
    loss (models/losses/simota.py) and in detect.py:decode_simota_eval."""

    def __init__(self, cin: int, cout: int, reg_max: int = 0, nc: int = 80,
                 deploy: bool = False, quant: bool = False, calibrate: bool = False):
        super().__init__()
        cv = _convish(deploy, quant, calibrate)
        self.stem = cv(cin, cout, 1, act="silu")
        self.cls_conv = cv(cout, cout, 3, act="silu")
        self.cls_pred = nn.Conv2d(cout, nc, 1)
        self.reg_conv = cv(cout, cout, 3, act="silu")
        self.reg_pred = nn.Conv2d(cout, 4 * (reg_max + 1), 1)
        self.obj_pred = nn.Conv2d(cout, 1, 1)
        if not deploy:
            prior_bias = -math.log((1 - 1e-2) / 1e-2)
            nn.init.constant_(self.cls_pred.bias, prior_bias)
            nn.init.constant_(self.obj_pred.bias, prior_bias)
            nn.init.zeros_(self.reg_pred.bias)

    def forward(self, x):
        x = self.stem(x)
        cls = self.cls_pred(self.cls_conv(x))
        reg_f = self.reg_conv(x)
        return cls.float(), self.reg_pred(reg_f).float(), self.obj_pred(reg_f).float()


def upsample2x(x):
    """nn.Upsample(scale=2, mode='nearest'): exact integer repeat."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample2x(nn.Module):
    """upsample2x with an output quantizer `up_q` (blocks.py:844-860), the
    neck upsample of a quant graph."""

    def __init__(self, calibrate: bool = False):
        super().__init__()
        self.up_q = QuantAct(calibrate)

    def forward(self, x):
        return self.up_q(upsample2x(x))


# ---------------------------------------------------------------------------
# The office graphs' blocks (EfficientRep / CSPBep, RepPAN, EffiDeHead) and
# their INT8 modes: blocks.py:872-1071 of the JAX package.


class RepBlock(nn.Module):
    """A chain of n RepVGG blocks: conv1 (cin -> cout), then block{i}. It
    stays multi-branch under repopt, as in JAX (graph.py:287-288 makes
    RepVGGBlock and MPRep rows plain only)."""

    def __init__(self, cin: int, cout: int, n: int = 1, deploy: bool = False,
                 quant: bool = False, calibrate: bool = False):
        super().__init__()
        self.n = n
        q = dict(deploy=deploy, quant=quant, calibrate=calibrate)
        self.conv1 = RepVGGBlock(cin, cout, **q)
        for i in range(n - 1):
            self.add_module(f"block{i}", RepVGGBlock(cout, cout, **q))

    def forward(self, x):
        x = self.conv1(x)
        for i in range(self.n - 1):
            x = getattr(self, f"block{i}")(x)
        return x


class BottleRep(nn.Module):
    """Two basic blocks and, where cin == cout, the identity weighted by a
    learnable `alpha` of shape (1,) (the reference's weight=True, which every
    BottleRep of a BepC3 takes). basic 'repvgg' takes RepVGG blocks
    (yolov6-m), 'conv' the 3x3 conv-BN-SiLU ConvWrapper (yolov6-l). Under
    quant the two blocks quantize; the alpha-weighted sum stays float."""

    def __init__(self, cin: int, cout: int, basic: str = "repvgg", deploy: bool = False,
                 quant: bool = False, calibrate: bool = False):
        super().__init__()
        q = dict(deploy=deploy, quant=quant, calibrate=calibrate)
        block = RepVGGBlock if basic == "repvgg" else ConvWrapper
        self.conv1 = block(cin, cout, **q)
        self.conv2 = block(cout, cout, **q)
        if cin == cout:
            self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if hasattr(self, "alpha"):
            return y + self.alpha.to(x.dtype) * x
        return y


def bepc3_chain_len(n: int) -> int:
    """BottleRep count in a BepC3 of repeat n: 1 + max(n // 2 - 1, 0)."""
    return 1 + max(n // 2 - 1, 0)


class BepC3(nn.Module):
    """CSP block: 1x1 cv1 and cv2 (conv-BN-SiLU) to c_ = cout * e, a
    BottleRep chain on cv1's branch, concat [chain, cv2], 1x1 cv3. n is the
    config's repeat count, before the halving of bepc3_chain_len."""

    def __init__(self, cin: int, cout: int, n: int = 1, e: float = 0.5,
                 basic: str = "repvgg", deploy: bool = False, quant: bool = False,
                 calibrate: bool = False):
        super().__init__()
        c_ = int(cout * e)
        cv = _convish(deploy, quant, calibrate)
        self.cv1 = cv(cin, c_, 1, act="silu")
        self.cv2 = cv(cin, c_, 1, act="silu")
        self.chain = bepc3_chain_len(n)
        q = dict(deploy=deploy, quant=quant, calibrate=calibrate)
        self.m_conv1 = BottleRep(c_, c_, basic, **q)
        for i in range(self.chain - 1):
            self.add_module(f"m_block{i}", BottleRep(c_, c_, basic, **q))
        self.cv3 = cv(2 * c_, cout, 1, act="silu")

    def forward(self, x):
        m = self.m_conv1(self.cv1(x))
        for i in range(self.chain - 1):
            m = getattr(self, f"m_block{i}")(m)
        return self.cv3(torch.cat([m, self.cv2(x)], 1))


class SimSPPF(nn.Module):
    """SPPF with ReLU cells (conv-BN-ReLU 1x1 in and out). With quant, one
    input quantizer `pool_q` is shared by the three pools (blocks.py:
    989-993), so calibration records the max over the three inputs."""

    def __init__(self, cin: int, cout: int, k: int = 5, deploy: bool = False,
                 quant: bool = False, calibrate: bool = False):
        super().__init__()
        c_ = cin // 2
        self.k = k
        cv = _convish(deploy, quant, calibrate)
        self.cv1 = cv(cin, c_, 1, act="relu")
        self.cv2 = cv(4 * c_, cout, 1, act="relu")
        self.pool_q = QuantAct(calibrate) if quant and deploy else nn.Identity()

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(self.pool_q(x), self.k)
        y2 = max_pool_same(self.pool_q(y1), self.k)
        y3 = max_pool_same(self.pool_q(y2), self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class TransposeUp(nn.Module):
    """2x upsample by a biased ConvTranspose2d with kernel = stride = 2: no
    two output blocks overlap, so out[2y+u, 2x+v] = W[u, v]^T x[y, x] + b.
    `weight` is held [cout, cin, 2, 2], the OIHW order of the bridge's other
    kernels (the JAX kernel is [2, 2, cin, cout]); it is the same in train
    and deploy form.

    With quant (blocks.py:1019-1026): the input quantizer `in_q`, and outside
    calib mode the kernel fake-quantized per output channel (the amax over
    dims 1-3 here, JAX's HWIO 0-2), in f32; in calib mode the kernel stays
    as it is. In int8 mode the op stays this fake-quant float op, as JAX's
    INT8_INFER reaches its _RawConv alone."""

    def __init__(self, cin: int, cout: int, deploy: bool = False, quant: bool = False,
                 calibrate: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 2, 2))
        bound = 1.0 / math.sqrt(4 * cin)
        nn.init.uniform_(self.weight, -bound, bound)
        self.bias = nn.Parameter(torch.zeros(cout))
        if quant and deploy:
            self.in_q = QuantAct(calibrate)

    def forward(self, x):
        w = self.weight
        if hasattr(self, "in_q"):
            x = self.in_q(x)
            if self.in_q.mode != "calib":
                w = w.float()
                w = fake_quant_sym(w, w.detach().abs().amax((1, 2, 3), keepdim=True))
        return F.conv_transpose2d(x, w.transpose(0, 1).to(x.dtype), self.bias.to(x.dtype),
                                  stride=2)


class Head_Effide(nn.Module):
    """One level of the Efficient Decoupled Head -> (stem feat, sigmoid(cls),
    raw DFL reg): 1x1 stem, then 3x3 cls_conv -> 1x1 cls_pred and 3x3
    reg_conv -> 1x1 reg_pred, every conv cin wide. Train form: zero pred
    kernels, cls bias at the 1e-2 prior, reg bias 1.0, outputs in f32;
    deploy form: outputs in the model dtype (as Head_DepthUni). Under quant
    stem, cls_conv and reg_conv quantize; the preds stay plain convs, as
    JAX's nn.Conv are."""

    def __init__(self, cin: int, reg_max: int = 16, nc: int = 80, deploy: bool = False,
                 quant: bool = False, calibrate: bool = False):
        super().__init__()
        self.deploy = deploy
        cv = _convish(deploy, quant, calibrate)
        self.stem = cv(cin, cin, 1, act="silu")
        self.cls_conv = cv(cin, cin, 3, act="silu")
        self.cls_pred = nn.Conv2d(cin, nc, 1)
        self.reg_conv = cv(cin, cin, 3, act="silu")
        self.reg_pred = nn.Conv2d(cin, 4 * (reg_max + 1), 1)
        if not deploy:
            prior = 1e-2
            nn.init.zeros_(self.cls_pred.weight)
            nn.init.constant_(self.cls_pred.bias, -math.log((1 - prior) / prior))
            nn.init.zeros_(self.reg_pred.weight)
            nn.init.constant_(self.reg_pred.bias, 1.0)

    def forward(self, x):
        x = self.stem(x)
        cls = self.cls_pred(self.cls_conv(x))
        reg = self.reg_pred(self.reg_conv(x))
        if self.deploy:
            return x, torch.sigmoid(cls), reg
        return x, torch.sigmoid(cls.float()), reg.float()
