"""Real-int8 convolutions: the CUDA kernels (csrc/int8_conv.cu for dense
convs, csrc/int8_dw.cu for depthwise ones) and their plain PyTorch versions.

Counterpart of the INT8_INFER branch of mafyolo_tpu/models/blocks.py:_RawConv
(306-321), which XLA computes with lax.conv_general_dilated(int8, int8,
preferred_element_type=int32). PyTorch has no int8 convolution on the card,
so the port writes both kernels by hand. The contract, for a conv of the
deploy graph with calibrated activation amax `a` and f32 weights w [O,I,k,k]:

    x_scale = max(a, 1e-12) / 127           per tensor
    w_scale = max(|w|.max over (I,k,k), 1e-12) / 127   per output channel
    x_q = clip(round_half_even(x / x_scale), -127, 127)   (IEEE division)
    w_q = clip(round_half_even(w / w_scale), -127, 127)
    acc = int32 conv(x_q, w_q)
    y = f32(acc) * (x_scale * w_scale) + bias   (a rounded multiply, then a
                                                 rounded add: no FMA)
    out = y cast to the activation dtype (bf16 on the card)

`pack` quantizes the weights once on the host (f32, CPU) into an Int8Pack;
the activations are quantized where they are loaded. `int8_conv` runs the
plain version on a CPU tensor and the kernel on a CUDA tensor; there is no
fallback from one to the other. The plain version's integer conv is exact:
an f64 conv of the integer-valued operands (every |sum| <= 127^2 * K <
2^53), on the CPU as on the card (torch's int64 CPU conv takes the same
sums 3-7x slower; tests/test_torch_quant_conv.py holds both to an int64
ground truth).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops._mma_pack import pack_b_s8, pad32, unpack_b_s8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG_CONV = {"int8_conv": [_P, _P, _P, _P, _P] + [_I] * 12 + [_F, _I, _P]}
_SIG_DW = {"int8_dw": [_P, _P, _P, _P, _P] + [_I] * 6 + [_F, _I, _P]}
DW_KERNELS = (3, 5, 7, 9)
QMAX = 127.0


@dataclasses.dataclass
class Int8Pack:
    """One conv's int8 weights and epilogue, packed once on the host.

    kind "dense" (groups 1: w_frag holds the [K, O] weight, K ordered (ky,
    kx, c) and padded to 32, in mma.m16n8k32 fragment order) or "dw"
    (depthwise, stride 1, 'same' pad: w_taps [k*k, C], tap-major).
    w_q is the OIHW int8 weight of the plain version, scale the f32
    x_scale * w_scale per output channel, x_scale_t x_scale as a
    one-element tensor on the pack's device (a tensor divisor, so that the
    division is a true one on every device)."""
    kind: str
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    groups: int
    x_scale: float
    x_scale_t: torch.Tensor
    w_q: torch.Tensor
    w_kernel: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor

    def to(self, device) -> "Int8Pack":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation scale, f32: max(amax, 1e-12) / 127."""
    amax = amax.float()
    return torch.clamp(amax, min=1e-12) / amax.new_tensor(QMAX)


def quantize_weights(weight: torch.Tensor):
    """f32 OIHW -> (w_q int8 OIHW, w_scale f32 [O]), per output channel."""
    w = weight.detach().float()
    w_scale = torch.clamp(w.abs().amax((1, 2, 3)), min=1e-12) / w.new_tensor(QMAX)
    w_q = torch.round(w / w_scale[:, None, None, None]).clamp_(-QMAX, QMAX)
    return w_q.to(torch.int8), w_scale


def pack(weight, bias, act_amax, stride: int, pad: int, groups: int) -> Int8Pack:
    """Quantize one conv's weights on the host (CPU, f32) into an Int8Pack."""
    weight = weight.detach().float().cpu()
    o, i, k, k2 = weight.shape
    x_scale = act_scale(act_amax.detach().cpu()).reshape(1)
    w_q, w_scale = quantize_weights(weight)
    if groups == o and i == 1 and stride == 1 and k == k2 and k in DW_KERNELS \
            and pad == k // 2:
        kind = "dw"
        w_kernel = w_q.reshape(o, k * k).t().contiguous()
    elif groups == 1:
        kind = "dense"
        w_kernel = pack_b_s8(w_q.permute(2, 3, 1, 0).reshape(k * k2 * i, o))
    else:
        raise ValueError(f"int8 conv: no kernel for k={k}x{k2} stride {stride} pad {pad} "
                         f"groups {groups} ({i} -> {o} channels)")
    return Int8Pack(kind, i * groups, o, k, stride, pad, groups, float(x_scale.item()),
                    x_scale, w_q, w_kernel, x_scale * w_scale,
                    bias.detach().float().cpu().clone())


def quantize(x: torch.Tensor, x_scale_t: torch.Tensor) -> torch.Tensor:
    """clip(round(x / x_scale), -127, 127) in f32 (integer values)."""
    return torch.round(x.float() / x_scale_t).clamp_(-QMAX, QMAX)


def _epilogue(acc: torch.Tensor, p: Int8Pack, dtype) -> torch.Tensor:
    """f32(acc) * scale, then + bias, as two rounded steps, then one cast."""
    y = acc.float() * p.scale.view(1, -1, 1, 1)
    y = y + p.bias.view(1, -1, 1, 1)
    return y.to(dtype).contiguous(memory_format=torch.channels_last)


def int8_conv_plain(x: torch.Tensor, p: Int8Pack) -> torch.Tensor:
    """x [B,C,H,W] (any layout, f32 or bf16) -> [B,O,Ho,Wo] channels_last in
    x's dtype; the integer conv exact in f64."""
    xq = quantize(x, p.x_scale_t).double()
    acc = F.conv2d(xq, p.w_q.double(), None, p.stride, p.pad, 1, p.groups)
    return _epilogue(acc, p, x.dtype)


def int8_conv_gemm_plain(x: torch.Tensor, p: Int8Pack) -> torch.Tensor:
    """The dense kernel's formulation: rows are output pixels, K the (ky, kx,
    c) taps of the quantized input padded to 32, columns the output channels
    of the fragment pack read back (unpack_b_s8); int64 on the CPU."""
    if p.kind != "dense":
        raise ValueError("int8_conv_gemm_plain: dense convs only")
    b, c, h, w = x.shape
    k, s, pad = p.k, p.stride, p.pad
    ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
    xq = F.pad(quantize(x, p.x_scale_t).to(torch.int64).permute(0, 2, 3, 1),
               (0, 0, pad, pad, pad, pad))                  # [B, H+2p, W+2p, C]
    taps = [xq[:, ky:ky + s * (ho - 1) + 1:s, kx:kx + s * (wo - 1) + 1:s]
            for ky in range(k) for kx in range(k)]
    a = torch.cat(taps, -1).reshape(b * ho * wo, k * k * c)
    a = F.pad(a, (0, pad32(k * k * c) - k * k * c))
    wmat = unpack_b_s8(p.w_kernel.cpu(), k * k * c, p.cout).to(torch.int64)
    acc = (a @ wmat)[:, :p.cout].reshape(b, ho, wo, p.cout).permute(0, 3, 1, 2)
    return _epilogue(acc, p, x.dtype)


def _as_nhwc(x: torch.Tensor):
    """x [B,C,H,W] whose memory is NHWC with a pixel pitch >= C (a channels_last
    tensor or a channel slice of one) -> (x, pitch); else a channels_last copy."""
    b, c, h, w = x.shape
    ld = x.stride(3)
    if not (x.stride(1) == 1 and x.stride(2) == w * ld and x.stride(0) == h * w * ld
            and ld >= c):
        x = x.contiguous(memory_format=torch.channels_last)
        ld = c
    return x, ld


def _launch_checks(x, p: Int8Pack, what: str):
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: want bf16 or f32 activations, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != p.cin:
        raise ValueError(f"{what}: want [B,{p.cin},H,W], got {tuple(x.shape)}")
    if p.w_kernel.device != x.device or p.scale.device != x.device:
        raise ValueError(f"{what}: the pack is on {p.w_kernel.device}, x on {x.device}")


def int8_conv(x: torch.Tensor, p: Int8Pack) -> torch.Tensor:
    """Real-int8 conv of one deploy-graph conv; routes a "dw" pack to
    int8_dw. See the module docstring for the contract."""
    if p.kind == "dw":
        return int8_dw(x, p)
    if x.device.type == "cpu":
        return int8_conv_plain(x, p)
    _launch_checks(x, p, "int8_conv")
    x, ld = _as_nhwc(x)
    b, c, h, w = x.shape
    ho, wo = (h + 2 * p.pad - p.k) // p.stride + 1, (w + 2 * p.pad - p.k) // p.stride + 1
    out = torch.empty((b, p.cout, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if b * ho * wo >= 2 ** 31 or b * h * w * ld >= 2 ** 31:
        raise ValueError(f"int8_conv: {tuple(x.shape)} exceeds 32-bit indexing")
    lib = _build.load("int8_conv", _SIG_CONV)
    err = lib.int8_conv(x.data_ptr(), p.w_kernel.data_ptr(), p.scale.data_ptr(),
                        p.bias.data_ptr(), out.data_ptr(), b, h, w, c, ld, ho, wo,
                        p.cout, p.k, p.stride, p.pad, pad32(p.k * p.k * c),
                        p.x_scale, int(x.dtype == torch.bfloat16),
                        _build.current_stream(x.device))
    _build.check(lib, err, "int8_conv kernel")
    int8_conv.launches += 1
    return out


def int8_dw(x: torch.Tensor, p: Int8Pack) -> torch.Tensor:
    """Real-int8 depthwise conv (stride 1, k in DW_KERNELS, 'same' pad)."""
    if p.kind != "dw":
        raise ValueError("int8_dw: want a depthwise pack")
    if x.device.type == "cpu":
        return int8_conv_plain(x, p)
    _launch_checks(x, p, "int8_dw")
    x, ld = _as_nhwc(x)
    b, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if b > 65535 or b * h * w * ld >= 2 ** 31:
        raise ValueError(f"int8_dw: {tuple(x.shape)} exceeds the grid or 32-bit indexing")
    lib = _build.load("int8_dw", _SIG_DW)
    err = lib.int8_dw(x.data_ptr(), p.w_kernel.data_ptr(), p.scale.data_ptr(),
                      p.bias.data_ptr(), out.data_ptr(), b, h, w, c, ld, p.k,
                      p.x_scale, int(x.dtype == torch.bfloat16),
                      _build.current_stream(x.device))
    _build.check(lib, err, "int8_dw kernel")
    int8_dw.launches += 1
    return out


int8_conv.launches = 0
int8_dw.launches = 0
