"""Fused front-end, deploy layers 0-2 or 0-1: the CUDA kernel
(csrc/frontend.cu) and its plain PyTorch version.

Counterpart of mafyolo_tpu/ops/frontend_pallas.py. The TPU kernel reads a
host-packed space-to-depth layout; the CUDA kernel reads the loader's uint8
BGR NHWC bytes as they are. Both versions here take one packed f32 weight
buffer (`frontend_build`), with /255 and the BGR->RGB flip folded into the
layer-0 weights as frontend_pallas.py:_w0_blocked does. `frontend_forward`
runs the plain version on a CPU tensor and the kernel on a CUDA tensor; there
is no fallback from one to the other. For bf16 output the kernel runs layers
0 and 1 and the 1x1 convs on the tensor cores, from a second, bf16 buffer
(`FrontendWeights.mma`) that holds those weights padded to 16 channels in
fragment order (`_mma_parts`, ops/_mma_pack.py); for f32 output it computes
everything in f32 from `flat`.

Two configurations, as the JAX kernel's `fuse_l2`: layers 0-2 (the RepVGG
3x3/s2 pair and a k=3 RepHDW, every MAF graph) and layers 0-1 alone (depth
0: the pair, then any other layer 2, as the YOLOv6 office graphs N and M
have; its config has c_ = mid = c2 = 0 and its output is c1 wide).
`frontend_skip_until` says which one a graph takes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops._mma_pack import pack_b, pad16, pad_rows

_SIG = {"frontend_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        "frontend_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        "frontend_bf16_tile": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 2,
        "frontend_weight_len": [ctypes.c_int] * 6,
        "frontend_mma_weight_len": [ctypes.c_int] * 6,
        "frontend_plan": [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 4}


@dataclasses.dataclass(frozen=True)
class FrontendCfg:
    """Channel structure of layers 0-2; depth 0 (and c_ = mid = c2 = 0) for
    layers 0-1 alone."""
    c0: int      # layer-0 output channels
    c1: int      # layer-1 output channels
    c_: int      # RepHDW split width (cout * expansion)
    mid: int     # bottleneck expand width (c_ * depth_expansion)
    depth: int   # RepHDW bottleneck count
    c2: int      # RepHDW output channels

    def dims(self):
        return (self.c0, self.c1, self.c_, self.mid, self.depth, self.c2)

    @property
    def cout(self) -> int:
        """Channels of the kernel's output: layer 2's, or layer 1's at depth 0."""
        return self.c2 if self.depth else self.c1


@dataclasses.dataclass(frozen=True)
class FrontendWeights:
    cfg: FrontendCfg
    flat: torch.Tensor   # f32 [n], the order of _layout
    mma: torch.Tensor    # bf16, the blocks of _mma_parts in fragment order


def _layout(cfg: FrontendCfg):
    """(name, shape) of each packed weight, in buffer order. Kernels are HWIO
    (output channel fastest); 1x1 kernels [Cin, Cout]; DW [9, C]."""
    c0, c1, c_, mid, depth, c2 = cfg.dims()
    out = [("w0", (3, 3, 3, c0)), ("b0", (c0,)), ("w1", (3, 3, c0, c1)), ("b1", (c1,))]
    if depth == 0:
        return out
    out += [("win", (c1, 2 * c_)), ("bin", (2 * c_,))]
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


def _mma_parts(parts, cfg: FrontendCfg):
    """[(name, f32 [K, N])]: the weights the bf16 kernel feeds to the tensor
    cores, in buffer order, as the GEMMs it runs. Every K segment the kernel
    walks is padded with zero rows to a multiple of 16: layer 0's 27 taps
    (u, v, ci) as one block, layer 1's 9 taps of c0 rows, and cv_out's
    2 + depth CSP parts of c_ rows. cv_in's output columns are laid out
    [a | b] with each half padded to 16, as x2 sits in shared memory. pack_b
    pads the rest."""
    c0, c1, c_, mid, depth, c2 = cfg.dims()
    out = [("w0", parts["w0"].reshape(27, c0)),
           ("w1", pad_rows(parts["w1"].reshape(9 * c0, c1), [c0] * 9))]
    if depth == 0:
        return out
    csp = pad16(c_)
    win = parts["win"].new_zeros((c1, 2 * csp))
    win[:, :c_] = parts["win"][:, :c_]
    win[:, csp:csp + c_] = parts["win"][:, c_:]
    out.append(("win", win))
    for i in range(depth):
        out += [(f"wexp{i}", parts[f"wexp{i}"]), (f"wproj{i}", parts[f"wproj{i}"])]
    return out + [("wout", pad_rows(parts["wout"], [c_] * (2 + depth)))]


def frontend_supported(specs, save) -> bool:
    """Layers 0-1 are the RepVGG 3x3/s2 pair and nothing else reads layer
    0's or 1's output (frontend_pallas.py:513-521)."""
    s0, s1 = specs[0], specs[1]
    return (s0.kind == "RepVGGBlock" and s0.kw.get("cin") == 3
            and s0.kw.get("stride") == 2 and s1.kind == "RepVGGBlock"
            and s1.kw.get("stride") == 2 and s1.frm == (-1,)
            and 0 not in save and 1 not in save)


def frontend_l2_supported(specs) -> bool:
    """Layer 2 fuses too when it is a k=3 RepHDW fed by layer 1
    (frontend_pallas.py:524-529)."""
    s2 = specs[2]
    return s2.kind == "RepHDW" and s2.frm == (-1,) and s2.kw.get("kersize") == 3


def frontend_skip_until(specs, save) -> int:
    """How deep the kernel covers the graph (frontend_pallas.py:532-536):
    2 (layers 0-2, every MAF graph), 1 (layers 0-1: the pair, then another
    layer 2) or -1 (the graph does not start with the pair)."""
    if not frontend_supported(specs, save):
        return -1
    return 2 if frontend_l2_supported(specs) else 1


def frontend_build(net, fuse_l2: bool = True) -> FrontendWeights:
    """Deploy GraphNet (its layer0..layer2 modules, layer0 and layer1 alone
    without fuse_l2) -> packed f32 weights, and the bf16 pack of the
    tensor-core operands, on the modules' device."""
    l0, l1 = net.layer0.fused.conv, net.layer1.fused.conv
    parts = {"w0": l0.weight.flip(1).permute(2, 3, 1, 0) / 255.0, "b0": l0.bias,
             "w1": l1.weight.permute(2, 3, 1, 0), "b1": l1.bias}
    if not fuse_l2:
        cfg = FrontendCfg(c0=l0.out_channels, c1=l1.out_channels, c_=0, mid=0, depth=0, c2=0)
        return _pack(cfg, parts)
    l2 = net.layer2
    c_ = l2.c_
    mid = l2.m0.expand.conv.out_channels
    cfg = FrontendCfg(c0=l0.out_channels, c1=l1.out_channels, c_=c_, mid=mid,
                      depth=l2.depth, c2=l2.cv_out.conv.out_channels)

    def pw(conv):   # 1x1 [Cout, Cin, 1, 1] -> [Cin, Cout]
        return conv.weight[:, :, 0, 0].t()

    parts.update({"win": pw(l2.cv_in.conv), "bin": l2.cv_in.conv.bias,
                  "wout": pw(l2.cv_out.conv), "bout": l2.cv_out.conv.bias})
    for i in range(cfg.depth):
        m = getattr(l2, f"m{i}")
        dw = m.dw.fused.conv
        parts.update({f"wexp{i}": pw(m.expand.conv), f"bexp{i}": m.expand.conv.bias,
                      f"wdw{i}": dw.weight[:, 0].reshape(mid, 9).t(),
                      f"bdw{i}": dw.bias,
                      f"wproj{i}": pw(m.project.conv),
                      f"bproj{i}": m.project.conv.bias})
    return _pack(cfg, parts)


def _pack(cfg: FrontendCfg, parts) -> FrontendWeights:
    with torch.no_grad():
        flat = torch.cat([parts[n].float().reshape(-1) for n, _ in _layout(cfg)])
        mma = torch.cat([pack_b(w) for _, w in _mma_parts(
            {n: parts[n].float() for n, _ in _layout(cfg)}, cfg)])
    return FrontendWeights(cfg, flat.contiguous(), mma.contiguous())


def frontend_plain(imgs_u8, fw: FrontendWeights, dtype=torch.float32):
    """Plain version: uint8 BGR NHWC [B,H,W,3] -> NHWC [B,H/4,W/4,cout]
    (layer 2's output, or at depth 0 layer 1's).

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
    if cfg.depth == 0:
        return x.permute(0, 2, 3, 1).to(dtype)
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
    """Layers 0-2 (0-1 at depth 0) of the deploy graph on uint8 BGR NHWC ->
    NHWC in `dtype`."""
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
    if fw.mma.device != imgs_u8.device or fw.mma.dtype != torch.bfloat16:
        raise ValueError("frontend_forward: the MMA pack must be bf16 on the input's device")
    lib = _build.load("frontend", _SIG)
    if lib.frontend_weight_len(*fw.cfg.dims()) != fw.flat.numel() \
            or lib.frontend_mma_weight_len(*fw.cfg.dims()) != fw.mma.numel():
        raise ValueError("frontend_forward: packed weight length mismatch")
    imgs_u8 = imgs_u8.contiguous()
    out = torch.empty((b, h // 4, w // 4, fw.cfg.cout), dtype=dtype,
                      device=imgs_u8.device)
    tail = (b, h, w, *fw.cfg.dims(), torch.cuda.current_stream(imgs_u8.device).cuda_stream)
    if dtype == torch.float32:
        err = lib.frontend_f32(imgs_u8.data_ptr(), fw.flat.data_ptr(), out.data_ptr(), *tail)
    else:
        err = lib.frontend_bf16(imgs_u8.data_ptr(), fw.flat.data_ptr(), fw.mma.data_ptr(),
                                out.data_ptr(), *tail)
    _build.check(lib, err, "frontend kernel")
    frontend_forward.launches += 1
    return out


frontend_forward.launches = 0


def frontend_plan(fw: FrontendWeights, dtype=torch.bfloat16):
    """(tile rows, tile columns, shared-memory bytes, threads per block) the
    kernel of `dtype` picks for these widths on the current card."""
    lib = _build.load("frontend", _SIG)
    out = [ctypes.c_int() for _ in range(4)]
    _build.check(lib, lib.frontend_plan(*fw.cfg.dims(), int(dtype == torch.bfloat16),
                                        *map(ctypes.byref, out)), "frontend_plan")
    return tuple(v.value for v in out)
