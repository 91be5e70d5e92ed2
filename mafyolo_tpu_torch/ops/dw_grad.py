"""Depthwise-conv weight gradient: the CUDA kernel (csrc/dw_grad.cu) and its
plain PyTorch version.

Counterpart of mafyolo_tpu/ops/dw_grad_pallas.py (dw_grad_planar and
dw_grad_kernel, one sum) and of the K^2 unrolled taps that
mafyolo_tpu/ops/dwconv.py:_bwd_rule runs by default:

    dk[c, 0, ky, kx] = sum_{b,h,w} x_pad[b, c, h + ky*d, w + kx*d] * g[b, c, h, w]

Tensors are NCHW-shaped with channels-last memory (the port runs
channels_last, so NHWC is the physical layout, as in the JAX package).
`dw_grad` runs the plain version on a CPU tensor and the kernel on a CUDA
tensor; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build

_SIG = {"dw_grad": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]}
KERNEL_SIZES = (1, 3, 5, 7, 9)
BLOCKS_PER_SM = 4          # pass 1 splits the tiles over about this many blocks per SM


def dw_grad_plain(x, g, k: int, pad: int, dilation: int = 1):
    """x [B,C,H,W], cotangent g [B,C,Ho,Wo] -> dk [C,1,k,k], accumulated in f32
    (f64 stays f64): the K^2 shifted multiply-reduce taps of dwconv.py:74-88."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (pad, pad, pad, pad))
    gf = g.to(acc)
    ho, wo = g.shape[2], g.shape[3]
    taps = [(xp[:, :, ky * dilation:ky * dilation + ho,
                kx * dilation:kx * dilation + wo] * gf).sum((0, 2, 3))
            for ky in range(k) for kx in range(k)]
    return torch.stack(taps, 1).reshape(x.shape[1], 1, k, k)


def dw_grad(x, g, k: int, pad: int, dilation: int = 1):
    """Depthwise weight gradient; see dw_grad_plain for the contract. On a CUDA
    tensor: f32 or bf16, channels-last memory, k in KERNEL_SIZES; a dilation
    whose staged tile exceeds the block's shared memory raises from the
    kernel's launch."""
    if x.device.type == "cpu":
        return dw_grad_plain(x, g, k, pad, dilation)
    if x.device.type != "cuda":
        raise RuntimeError(f"dw_grad: unsupported device {x.device}")
    b, c, h, w = x.shape
    ho, wo = h + 2 * pad - dilation * (k - 1), w + 2 * pad - dilation * (k - 1)
    if (x.dtype not in (torch.float32, torch.bfloat16) or g.dtype != x.dtype
            or g.device != x.device or tuple(g.shape) != (b, c, ho, wo)):
        raise ValueError("dw_grad: want x and g f32 or bf16 on one device, g "
                         f"[B,C,Ho,Wo] = {(b, c, ho, wo)}; got {x.dtype} "
                         f"{tuple(x.shape)} / {g.dtype} {tuple(g.shape)}")
    if not (x.is_contiguous(memory_format=torch.channels_last)
            and g.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("dw_grad: x and g must be channels-last contiguous "
                         f"(strides {x.stride()} / {g.stride()})")
    if k not in KERNEL_SIZES or dilation < 1 or pad < 0:
        raise ValueError(f"dw_grad: unsupported k={k} pad={pad} dilation={dilation}")
    out = torch.empty((c, 1, k, k), dtype=torch.float32, device=x.device)
    if b == 0 or c == 0 or ho <= 0 or wo <= 0:
        return out.zero_()
    n_tiles = b * -(-ho // 16) * -(-wo // 16)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_split = max(1, min(n_tiles, BLOCKS_PER_SM * sms // -(-c // 32)))
    part = torch.empty((n_split, k * k, c), dtype=torch.float32, device=x.device)
    lib = _build.load("dw_grad", _SIG)
    err = lib.dw_grad(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
                      int(x.dtype == torch.bfloat16), b, h, w, c, ho, wo, k, pad,
                      dilation, n_split,
                      torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "dw_grad kernel")
    dw_grad.launches += 1
    return out


dw_grad.launches = 0
