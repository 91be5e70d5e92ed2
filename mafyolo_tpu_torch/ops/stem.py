"""Stem conv, deploy layer 0: the CUDA kernel (csrc/stem.cu) and its plain
PyTorch version.

Counterpart of mafyolo_tpu/ops/stem_pallas.py. Both compute
relu(conv3x3/s2(rgb(u8)/255) + b) for the Cin=3 RepVGG stem, from uint8 BGR
NHWC loader bytes, with /255 and the BGR->RGB flip folded into one packed
weight buffer (`stem_build`). The TPU kernel writes plane-major
[B,H/2,O,W/2] for its lane layout; here the output is NHWC [B,H/2,W/2,O],
what the deploy model built with skip_stem=True takes. `stem_conv_s2` runs
the plain version on a CPU tensor and the kernel on a CUDA tensor; there is
no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SIG = {"stem_f32": _ARGS, "stem_bf16": _ARGS}


@dataclasses.dataclass(frozen=True)
class StemWeights:
    flat: torch.Tensor   # f32 [27*O + O]: kernel HWIO [3,3,3(BGR),O] / 255, then bias

    @property
    def cout(self) -> int:
        return self.flat.numel() // 28


def stem_supported(specs) -> bool:
    """True when layer 0 is the RepVGG 3x3/s2 RGB stem the kernel replaces
    (every shipped MAF graph); stem_pallas.py:137-143."""
    kw = specs[0].kw
    return specs[0].kind == "RepVGGBlock" and kw.get("cin") == 3 and kw.get("stride") == 2


def stem_build(net) -> StemWeights:
    """Deploy GraphNet (its layer0 module) -> packed f32 weights on the
    module's device: the input-channel axis flipped (BGR bytes in) and /255
    folded in, as frontend_build does for w0."""
    conv = net.layer0.fused.conv
    with torch.no_grad():
        w = (conv.weight.flip(1).permute(2, 3, 1, 0) / 255.0).float()
        flat = torch.cat([w.reshape(-1), conv.bias.float()])
    return StemWeights(flat.contiguous())


def _check_shape(imgs_u8):
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 4 or imgs_u8.shape[3] != 3:
        raise ValueError("stem_conv_s2: want uint8 [B,H,W,3], got "
                         f"{imgs_u8.dtype} {tuple(imgs_u8.shape)}")
    if imgs_u8.shape[1] % 2 or imgs_u8.shape[2] % 2:
        raise ValueError("stem_conv_s2: H and W must be even, got "
                         f"{imgs_u8.shape[1]}x{imgs_u8.shape[2]}")


def stem_plain(imgs_u8, sw: StemWeights, dtype=torch.float32):
    """Plain version: uint8 BGR NHWC [B,H,W,3] -> NHWC [B,H/2,W/2,O] of
    relu(conv3x3/s2 + b), computed in f32 and cast to `dtype`."""
    _check_shape(imgs_u8)
    o = sw.cout
    w = sw.flat[:27 * o].view(3, 3, 3, o).permute(3, 2, 0, 1)
    x = imgs_u8.permute(0, 3, 1, 2).float()
    y = F.relu(F.conv2d(x, w, sw.flat[27 * o:], stride=2, padding=1))
    return y.permute(0, 2, 3, 1).to(dtype)


def stem_conv_s2(imgs_u8, sw: StemWeights, dtype=torch.float32):
    """Layer 0 of the deploy graph on uint8 BGR NHWC -> NHWC in `dtype`.
    H and W must be even; on a CUDA tensor, O a multiple of 8."""
    _check_shape(imgs_u8)
    if imgs_u8.device.type == "cpu":
        return stem_plain(imgs_u8, sw, dtype)
    if imgs_u8.device.type != "cuda":
        raise RuntimeError(f"stem_conv_s2: unsupported device {imgs_u8.device}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem_conv_s2: dtype {dtype} not supported")
    o = sw.cout
    if (sw.flat.device != imgs_u8.device or sw.flat.dtype != torch.float32
            or sw.flat.numel() != 28 * o or o % 8):
        raise ValueError("stem_conv_s2: weights must be f32 [28*O] on the input's "
                         f"device with O a multiple of 8, got {sw.flat.numel()} "
                         f"{sw.flat.dtype} on {sw.flat.device}")
    b, h, w, _ = imgs_u8.shape
    imgs_u8 = imgs_u8.contiguous()
    out = torch.empty((b, h // 2, w // 2, o), dtype=dtype, device=imgs_u8.device)
    if out.numel() == 0:
        return out
    lib = _build.load("stem", _SIG)
    fn = lib.stem_f32 if dtype == torch.float32 else lib.stem_bf16
    err = fn(imgs_u8.data_ptr(), sw.flat.data_ptr(), out.data_ptr(), b, h, w, o,
             torch.cuda.current_stream(imgs_u8.device).cuda_stream)
    _build.check(lib, err, "stem kernel")
    stem_conv_s2.launches += 1
    return out


stem_conv_s2.launches = 0


def stem_apply(model, sw: StemWeights, imgs_u8, dtype=None):
    """Counterpart of stem_pallas.py:pallas_stem_apply: the stem kernel on
    the raw uint8 batch, then a deploy model built with skip_stem=True
    (layers 1-33). dtype defaults to the model's parameter dtype."""
    if model.net.skip_until != 0:
        raise ValueError("stem_apply: the model must be built with skip_stem=True "
                         f"(skip_until {model.net.skip_until})")
    if dtype is None:
        dtype = next(model.parameters()).dtype
    return model(stem_conv_s2(imgs_u8, sw, dtype))
