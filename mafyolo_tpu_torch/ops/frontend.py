"""Fused front-end, deploy layers 0-2: the CUDA kernel (csrc/frontend.cu) and
its plain PyTorch version.

Counterpart of mafyolo_tpu/ops/frontend_pallas.py. The TPU kernel reads a
host-packed space-to-depth layout; the CUDA kernel reads the loader's uint8
BGR NHWC bytes as they are. Both versions here take one packed f32 weight
buffer (`frontend_build`), with /255 and the BGR->RGB flip folded into the
layer-0 weights as frontend_pallas.py:_w0_blocked does. `frontend_forward`
runs the plain version on a CPU tensor and the kernel on a CUDA tensor; there
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_SIG = {"frontend_f32": _ARGS, "frontend_bf16": _ARGS,
        "frontend_weight_len": [ctypes.c_int] * 6,
        "frontend_plan": [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3}


@dataclasses.dataclass(frozen=True)
class FrontendCfg:
    """Channel structure of layers 0-2."""
    c0: int      # layer-0 output channels
    c1: int      # layer-1 output channels
    c_: int      # RepHDW split width (cout * expansion)
    mid: int     # bottleneck expand width (c_ * depth_expansion)
    depth: int   # RepHDW bottleneck count
    c2: int      # RepHDW output channels

    def dims(self):
        return (self.c0, self.c1, self.c_, self.mid, self.depth, self.c2)


@dataclasses.dataclass(frozen=True)
class FrontendWeights:
    cfg: FrontendCfg
    flat: torch.Tensor   # f32 [n], the order of _layout


def _layout(cfg: FrontendCfg):
    """(name, shape) of each packed weight, in buffer order. Kernels are HWIO
    (output channel fastest); 1x1 kernels [Cin, Cout]; DW [9, C]."""
    c0, c1, c_, mid, depth, c2 = cfg.dims()
    out = [("w0", (3, 3, 3, c0)), ("b0", (c0,)), ("w1", (3, 3, c0, c1)),
           ("b1", (c1,)), ("win", (c1, 2 * c_)), ("bin", (2 * c_,))]
    for i in range(depth):
        out += [(f"wexp{i}", (c_, mid)), (f"bexp{i}", (mid,)),
                (f"wdw{i}", (9, mid)), (f"bdw{i}", (mid,)),
                (f"wproj{i}", (mid, c_)), (f"bproj{i}", (c_,))]
    return out + [("wout", ((2 + depth) * c_, c2)), ("bout", (c2,))]


def _unpack(fw: FrontendWeights):
    parts, off = {}, 0
    for name, shape in _layout(fw.cfg):
        n = math.prod(shape)
        parts[name] = fw.flat[off:off + n].view(shape)
        off += n
    return parts


def frontend_skip_until(specs, save) -> int:
    """2 when layers 0-2 are the RepVGG 3x3/s2 pair + a k=3 RepHDW fed by it
    and nothing else reads layers 0-1 (every MAF graph); -1 otherwise."""
    s0, s1, s2 = specs[0].kw, specs[1].kw, specs[2].kw
    ok = (specs[0].kind == "RepVGGBlock" and s0.get("cin") == 3
          and s0.get("stride") == 2 and specs[1].kind == "RepVGGBlock"
          and s1.get("stride") == 2 and specs[1].frm == (-1,)
          and specs[2].kind == "RepHDW" and specs[2].frm == (-1,)
          and s2.get("kersize") == 3 and 0 not in save and 1 not in save)
    return 2 if ok else -1


def frontend_build(net) -> FrontendWeights:
    """Deploy GraphNet (its layer0..layer2 modules) -> packed f32 weights on
    the modules' device."""
    l0, l1, l2 = net.layer0.fused.conv, net.layer1.fused.conv, net.layer2
    c_ = l2.c_
    mid = l2.m0.expand.conv.out_channels
    cfg = FrontendCfg(c0=l0.out_channels, c1=l1.out_channels, c_=c_, mid=mid,
                      depth=l2.depth, c2=l2.cv_out.conv.out_channels)

    def pw(conv):   # 1x1 [Cout, Cin, 1, 1] -> [Cin, Cout]
        return conv.weight[:, :, 0, 0].t()

    parts = {"w0": l0.weight.flip(1).permute(2, 3, 1, 0) / 255.0, "b0": l0.bias,
             "w1": l1.weight.permute(2, 3, 1, 0), "b1": l1.bias,
             "win": pw(l2.cv_in.conv), "bin": l2.cv_in.conv.bias,
             "wout": pw(l2.cv_out.conv), "bout": l2.cv_out.conv.bias}
    for i in range(cfg.depth):
        m = getattr(l2, f"m{i}")
        dw = m.dw.fused.conv
        parts.update({f"wexp{i}": pw(m.expand.conv), f"bexp{i}": m.expand.conv.bias,
                      f"wdw{i}": dw.weight[:, 0].reshape(mid, 9).t(),
                      f"bdw{i}": dw.bias,
                      f"wproj{i}": pw(m.project.conv),
                      f"bproj{i}": m.project.conv.bias})
    with torch.no_grad():
        flat = torch.cat([parts[n].float().reshape(-1) for n, _ in _layout(cfg)])
    return FrontendWeights(cfg, flat.contiguous())


def frontend_plain(imgs_u8, fw: FrontendWeights, dtype=torch.float32):
    """Plain version: uint8 BGR NHWC [B,H,W,3] -> NHWC [B,H/4,W/4,c2].

    Computes in f32 with ordinary convolutions (zero padding at every layer)
    and casts the result to `dtype`, as the kernel does."""
    p = _unpack(fw)
    cfg = fw.cfg

    def hwio(w):
        return w.permute(3, 2, 0, 1)

    def pw(x, w, b):
        return F.silu(F.conv2d(x, w.t()[:, :, None, None], b))

    x = imgs_u8.permute(0, 3, 1, 2).float()
    x = F.relu(F.conv2d(x, hwio(p["w0"]), p["b0"], stride=2, padding=1))
    x = F.relu(F.conv2d(x, hwio(p["w1"]), p["b1"], stride=2, padding=1))
    x2 = pw(x, p["win"], p["bin"])
    outs = [x2[:, :cfg.c_], x2[:, cfg.c_:]]
    for i in range(cfg.depth):
        t = pw(outs[-1], p[f"wexp{i}"], p[f"bexp{i}"])
        wdw = p[f"wdw{i}"].t().reshape(cfg.mid, 1, 3, 3)
        t = F.silu(F.conv2d(t, wdw, p[f"bdw{i}"], padding=1, groups=cfg.mid))
        outs.append(pw(t, p[f"wproj{i}"], p[f"bproj{i}"]))
    y = pw(torch.cat(outs, 1), p["wout"], p["bout"])
    return y.permute(0, 2, 3, 1).to(dtype)


def frontend_forward(imgs_u8, fw: FrontendWeights, dtype=torch.float32):
    """Layers 0-2 of the deploy graph on uint8 BGR NHWC -> NHWC in `dtype`."""
    if imgs_u8.device.type == "cpu":
        return frontend_plain(imgs_u8, fw, dtype)
    if imgs_u8.device.type != "cuda":
        raise RuntimeError(f"frontend_forward: unsupported device {imgs_u8.device}")
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 4 or imgs_u8.shape[3] != 3:
        raise ValueError("frontend_forward: want uint8 [B,H,W,3], got "
                         f"{imgs_u8.dtype} {tuple(imgs_u8.shape)}")
    b, h, w, _ = imgs_u8.shape
    if h % 4 or w % 4:
        raise ValueError(f"frontend_forward: H, W must be multiples of 4, got {h}x{w}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"frontend_forward: dtype {dtype} not supported")
    if fw.flat.device != imgs_u8.device or fw.flat.dtype != torch.float32:
        raise ValueError("frontend_forward: weights must be f32 on the input's device")
    lib = _build.load("frontend", _SIG)
    if lib.frontend_weight_len(*fw.cfg.dims()) != fw.flat.numel():
        raise ValueError("frontend_forward: packed weight length mismatch")
    imgs_u8 = imgs_u8.contiguous()
    out = torch.empty((b, h // 4, w // 4, fw.cfg.c2), dtype=dtype,
                      device=imgs_u8.device)
    fn = lib.frontend_f32 if dtype == torch.float32 else lib.frontend_bf16
    err = fn(imgs_u8.data_ptr(), fw.flat.data_ptr(), out.data_ptr(), b, h, w,
             *fw.cfg.dims(), torch.cuda.current_stream(imgs_u8.device).cuda_stream)
    _build.check(lib, err, "frontend kernel")
    frontend_forward.launches += 1
    return out


frontend_forward.launches = 0


def frontend_plan(fw: FrontendWeights):
    """(tile, shared-memory bytes, threads per block) the kernel picks for
    these widths on the current card."""
    lib = _build.load("frontend", _SIG)
    out = [ctypes.c_int() for _ in range(3)]
    _build.check(lib, lib.frontend_plan(*fw.cfg.dims(), *map(ctypes.byref, out)),
                 "frontend_plan")
    return tuple(v.value for v in out)
