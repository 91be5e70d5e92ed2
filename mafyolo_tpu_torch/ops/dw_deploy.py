"""The deploy graphs' depthwise conv on the card (csrc/dw_conv.cu), its
plain PyTorch versions and its routing.

A deploy-form depthwise conv is one biased conv, stride 1, and the
activation that follows it in the graph (SiLU after a RepHDW bottleneck's,
none after a head's). The contract, for activations x [B,C,H,W] (NHWC in
memory, bf16 or f32), weights [C,1,k,k] in x's dtype and a bias [C] (f32
or x's dtype):

    out = cast_to_x_dtype(act(f32(sum over the k x k taps of x * w) + bias))

with zeros outside the image and one rounding. `dw_conv` calls the custom
op `mafyolo::dw_conv` (registered when this module is imported; its fake
gives the output's shape, so that torch.export can record it), which runs
the plain version on a CPU tensor and the kernel on a CUDA tensor, and
counts the kernel's launches in `dw_conv.launches`. dw_conv_tiles_plain is
the kernel's formulation tile by tile, which the tests hold to F.conv2d,
and dw_tile the planner the kernel takes its tile from.

`takes_kernel(conv, x)` is the routing rule that models/blocks.py:ConvAct
applies: a biased nn.Conv2d (not a QuantConv2d, whose modes keep their own
path) with groups == in == out channels, stride 1, dilation 1, an odd
square k in 3..9 and 'same' zero padding, on a CUDA tensor in bf16 or f32 of the
weights' dtype, while autograd records nothing. Everything else (the train
form's DWConv, every quant mode, strided sites) is left as it was.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops.quant_conv import _as_nhwc

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"dw_conv": [_P, _P, _P, _P] + [_I] * 11 + [_P]}
KERNELS = (3, 5, 7, 9)
ACTS = {None: lambda y: y, "relu": F.relu, "silu": F.silu}
_ACT_CODE = {None: 0, "relu": 1, "silu": 2}
CG, RY, RX = 32, 4, 4       # channels an item; output rows and columns a thread
# Shared memory a block may take: two blocks an SM of the H100's 227 KB
# (less the 1 KB the card keeps for each block), so that one block's
# compute overlaps another's copies; and what a block may take at most.
SMEM_LIMIT = 112 * 1024
SMEM_MAX = 227 * 1024
# The tile side by kernel size, for images whose two windows do not fit in
# SMEM_LIMIT. N's sites past the front-end are k 5 at 80 px, k 7 at 40 and
# k 9 at 20 (whole); S and M have the same classes, wider.
TILE = {3: 16, 5: 16, 7: 20, 9: 20}


def smem_bytes(k: int, th: int, tw: int, esize: int = 2) -> int:
    """Shared memory of a block of a th x tw tile (csrc/dw_conv.cu): two
    windows of whole RY x RX output groups and their halo, CG channels of
    esize bytes."""
    wh, ww = -(-th // RY) * RY + k - 1, -(-tw // RX) * RX + k - 1
    return 2 * wh * ww * CG * esize


def dw_tile(k: int, h: int, w: int, esize: int = 2):
    """(th, tw): the whole image where its block fits in SMEM_LIMIT, else
    TILE[k] a side (at most the image's), less 4 at a time until the block
    fits in SMEM_MAX."""
    if smem_bytes(k, h, w, esize) <= SMEM_LIMIT:
        return h, w
    side = TILE[k]
    while side > RY and smem_bytes(k, min(side, h), min(side, w), esize) > SMEM_MAX:
        side -= RY
    return min(side, h), min(side, w)


def takes_kernel(conv: nn.Module, x: torch.Tensor) -> bool:
    """Whether ConvAct runs `conv` on x through dw_conv: see the module
    docstring."""
    if type(conv) is not nn.Conv2d:
        return False
    k = conv.kernel_size[0]
    bias = conv.bias
    grad = torch.is_grad_enabled() and (
        x.requires_grad or conv.weight.requires_grad
        or (bias is not None and bias.requires_grad))
    return (bias is not None and conv.groups == conv.in_channels == conv.out_channels
            and conv.kernel_size == (k, k) and k in KERNELS
            and conv.stride == (1, 1) and conv.dilation == (1, 1)
            and conv.padding == (k // 2, k // 2) and conv.padding_mode == "zeros"
            and x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float32)
            and conv.weight.dtype == x.dtype and not grad)


def dw_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  act: Optional[str] = None) -> torch.Tensor:
    """The contract in plain PyTorch: the conv and the bias in f32, the
    activation, one cast to x's dtype."""
    k = weight.shape[-1]
    y = F.conv2d(x.float(), weight.float(), bias.float(), padding=k // 2, groups=x.shape[1])
    return ACTS[act](y).to(x.dtype)


def dw_conv_tiles_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        act: Optional[str] = None, tile=None) -> torch.Tensor:
    """The kernel's formulation tile by tile in f32: each th x tw tile's
    window of whole RY x RX output groups and its halo, zero outside the
    image; each output the sum of its taps in (ky, kx) order, then the bias,
    the activation and one cast. tile=None takes dw_tile's."""
    b, c, h, w = x.shape
    k = weight.shape[-1]
    half = k // 2
    th, tw = dw_tile(k, h, w, x.element_size()) if tile is None else tile
    wt = weight.float().reshape(c, k, k)
    bi = bias.float().cpu()
    nh, nw = -(-th // RY) * RY, -(-tw // RX) * RX          # outputs a tile computes
    out = torch.empty(b, c, h, w, dtype=x.dtype)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            iy = torch.arange(y0 - half, y0 - half + nh + k - 1)
            ix = torch.arange(x0 - half, x0 - half + nw + k - 1)
            vy, vx = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
            win = torch.zeros(b, c, iy.numel(), ix.numel())
            win[:, :, vy.nonzero()[:, 0][:, None], vx.nonzero()[:, 0][None]] = \
                x[:, :, iy[vy][:, None], ix[vx][None]].float()
            acc = torch.zeros(b, c, nh, nw)
            for ky in range(k):
                for kx in range(k):
                    acc += win[:, :, ky:ky + nh, kx:kx + nw] * wt[:, ky, kx][None, :, None, None]
            y = ACTS[act](acc + bi[None, :, None, None]).to(x.dtype)
            ny, nx = min(th, h - y0), min(tw, w - x0)
            out[:, :, y0:y0 + ny, x0:x0 + nx] = y[:, :, :ny, :nx]
    return out.contiguous(memory_format=torch.channels_last)


def dw_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            act: Optional[str] = None) -> torch.Tensor:
    """Deploy depthwise conv (stride 1, 'same' pad, k in KERNELS) with the
    bias and `act` (None, "relu" or "silu") fused, through the op
    `mafyolo::dw_conv`."""
    if act not in ACTS:
        raise ValueError(f"dw_conv: unknown activation {act!r}")
    return torch.ops.mafyolo.dw_conv(x, weight, bias, act)


def _checks(x, weight, bias):
    c = x.shape[1] if x.dim() == 4 else -1
    k = weight.shape[-1]
    if x.dim() != 4 or tuple(weight.shape) != (c, 1, k, k) or k not in KERNELS:
        raise ValueError(f"dw_conv: want x [B,C,H,W] and weights [C,1,k,k] with k in "
                         f"{KERNELS}, got {tuple(x.shape)} and {tuple(weight.shape)}")
    if tuple(bias.shape) != (c,):
        raise ValueError(f"dw_conv: want a bias of {c}, got {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise RuntimeError(f"dw_conv: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or weight.dtype != x.dtype:
        raise ValueError(f"dw_conv: want bf16 or f32 activations and weights of their dtype, "
                         f"got {x.dtype} and {weight.dtype}")
    if bias.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"dw_conv: want an f32 bias or one of x's dtype, got {bias.dtype}")
    for t in (weight, bias):
        if t.device != x.device:
            raise ValueError(f"dw_conv: a parameter is on {t.device}, x on {x.device}")


def _dw_conv_impl(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  act: Optional[str]) -> torch.Tensor:
    """The op `mafyolo::dw_conv`: the plain version on a CPU tensor, the
    kernel on a CUDA tensor (an empty one launches nothing), a raise on any
    other device."""
    _checks(x, weight, bias)
    if x.device.type == "cpu":
        return dw_conv_plain(x, weight, bias, act).contiguous(memory_format=torch.channels_last)
    out = dw_launch(x, weight, bias, act)
    if out.numel():
        dw_conv.launches += 1
    return out


_dw_conv_op = torch.library.custom_op("mafyolo::dw_conv", _dw_conv_impl, mutates_args=())


@_dw_conv_op.register_fake
def _(x, weight, bias, act):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def dw_launch(x, weight, bias, act=None, tile=None):
    """One launch of the kernel on a checked CUDA input; tile overrides
    dw_tile's. Counts no launch."""
    x, ld = _as_nhwc(x)
    b, c, h, w = x.shape
    k = weight.shape[-1]
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if b * h * w * ld >= 2 ** 31:
        raise ValueError(f"dw_conv: {tuple(x.shape)} exceeds 32-bit item counts")
    weight = weight.contiguous()
    th, tw = tile or dw_tile(k, h, w, x.element_size())
    lib = _build.load("dw_conv", _SIG)
    err = lib.dw_conv(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                      b, h, w, c, ld, k, th, tw, _ACT_CODE[act], int(x.dtype == torch.bfloat16),
                      int(bias.dtype == torch.float32), _build.current_stream(x.device))
    _build.check(lib, err, "dw_conv kernel")
    return out


dw_conv.launches = 0
