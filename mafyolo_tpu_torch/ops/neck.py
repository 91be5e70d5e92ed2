"""P3 neck cluster, deploy layers 19-22: the CUDA kernel (csrc/neck80.cu) and
its plain PyTorch version.

Counterpart of mafyolo_tpu/ops/neck_pallas.py:
Concat(L18, L4, L17up) -> RepHDW(k5) -> Concat(y20, L17up) -> RepHDW(k5),
from three NHWC sources to (y20, y22) NHWC. As in the JAX package the
function is not wired into the model: it computes the same as the deploy
model's own layers 19-22, which stay on the main path.

Both versions take one packed f32 weight buffer (`neck80_build`). cv_in's
weight rows come one block per concat source, so the kernel never
materialises either Concat; the CSP parts keep the port's order [a, b, y0..]
with the bottlenecks chained on the second half (models/blocks.py:RepHDW),
not the JAX kernel's b-first layout. `neck80_forward` runs the plain version
on CPU tensors and the kernel on CUDA tensors; there is no fallback from one
to the other. In bf16 the kernel runs its 1x1 convs on the tensor cores from
a second, bf16 buffer (`Neck80Weights.mma`: each GEMM's [K, N] weight in
fragment order, ops/_mma_pack.py); in f32 it computes everything from `flat`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops._mma_pack import pack_b

_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
_SIG = {"neck80_f32": _ARGS, "neck80_bf16": _ARGS,
        "neck80_weight_len": [ctypes.c_int] * 11}


@dataclasses.dataclass(frozen=True)
class Neck80Cfg:
    """Static geometry of the cluster (from specs 19-22); the fields of
    neck_pallas.py:Neck80Cfg."""
    h: int         # feature rows and cols (80 at 640 px)
    cins: tuple    # channels of (L18, L4, L17up)
    c20: int       # layer-20 output channels
    c22: int       # layer-22 output channels
    d1: int        # layer-20 bottleneck count
    d2: int        # layer-22 bottleneck count
    c1_: int       # layer-20 split width
    mid1: int
    c2_: int       # layer-22 split width
    mid2: int
    k: int = 5

    def dims(self):
        return (*self.cins, self.c20, self.c22, self.d1, self.d2, self.c1_,
                self.mid1, self.c2_, self.mid2)


@dataclasses.dataclass(frozen=True)
class Neck80Weights:
    cfg: Neck80Cfg
    flat: torch.Tensor   # f32 [n], the order of _layout
    mma: torch.Tensor    # bf16: the GEMM weights of _mma_names in fragment order


def neck80_supported(specs) -> bool:
    """True for the shipped MAF wiring: rows 19-22 are Concat(-1,4,-2) ->
    RepHDW(k5) -> Concat(-1,17) -> RepHDW(k5) fed by ConvWrapper(18),
    RepHDW(4) and Upsample(17) (neck_pallas.py:72-83)."""
    if len(specs) < 23:
        return False
    k19, k20, k21, k22 = (specs[i] for i in range(19, 23))
    return (k19.kind == "Concat" and k19.frm == (-1, 4, -2)
            and k20.kind == "RepHDW" and k20.kw["kersize"] == 5
            and k21.kind == "Concat" and k21.frm == (-1, 17)
            and k22.kind == "RepHDW" and k22.kw["kersize"] == 5
            and specs[18].kind == "ConvWrapper" and specs[17].kind == "Upsample")


def neck80_cfg(specs, h: int) -> Neck80Cfg:
    kw20, kw22 = specs[20].kw, specs[22].kw
    c1_ = int(kw20["cout"] * kw20["expansion"])
    c2_ = int(kw22["cout"] * kw22["expansion"])
    return Neck80Cfg(
        h=h, cins=(specs[18].cout, specs[4].cout, specs[17].cout),
        c20=kw20["cout"], c22=kw22["cout"], d1=kw20["depth"], d2=kw22["depth"],
        c1_=c1_, mid1=int(c1_ * kw20["depth_expansion"]),
        c2_=c2_, mid2=int(c2_ * kw22["depth_expansion"]))


def _layer_layout(tag, cin, c_, mid, depth, cout):
    out = [(f"{tag}win", (cin, 2 * c_)), (f"{tag}bin", (2 * c_,))]
    for i in range(depth):
        out += [(f"{tag}wexp{i}", (c_, mid)), (f"{tag}bexp{i}", (mid,)),
                (f"{tag}wdw{i}", (25, mid)), (f"{tag}bdw{i}", (mid,)),
                (f"{tag}wproj{i}", (mid, c_)), (f"{tag}bproj{i}", (c_,))]
    return out + [(f"{tag}wout", ((2 + depth) * c_, cout)), (f"{tag}bout", (cout,))]


def _layout(cfg: Neck80Cfg):
    """(name, shape) of each packed weight, in buffer order: layer 20, then
    layer 22. 1x1 kernels [Cin, Cout] (cv_in's rows in concat-source order,
    cv_out's in CSP order); DW [25, C]."""
    return (_layer_layout("l20.", sum(cfg.cins), cfg.c1_, cfg.mid1, cfg.d1, cfg.c20)
            + _layer_layout("l22.", cfg.c20 + cfg.cins[2], cfg.c2_, cfg.mid2, cfg.d2,
                            cfg.c22))


def _mma_names(cfg: Neck80Cfg):
    """Names of the 1x1 weights in the order the kernel launches its GEMMs."""
    return [name for name, shape in _layout(cfg)
            if len(shape) == 2 and "wdw" not in name]


def _mma_ok(cfg: Neck80Cfg) -> bool:
    """Whether the tensor-core GEMMs take these widths: K in tiles of 16,
    output columns in interleaved groups of 32 (every MAF width does)."""
    return not (any(c % 16 for c in cfg.cins)
                or any(c % 32 for c in (cfg.c1_, cfg.mid1, cfg.c20, cfg.c2_, cfg.mid2, cfg.c22)))


def _unpack(nw: Neck80Weights):
    parts, off = {}, 0
    for name, shape in _layout(nw.cfg):
        n = math.prod(shape)
        parts[name] = nw.flat[off:off + n].view(shape)
        off += n
    return parts


def neck80_build(net, cfg: Neck80Cfg) -> Neck80Weights:
    """Deploy GraphNet (its layer20 and layer22 modules) -> packed f32
    weights on the modules' device."""
    def pw(conv):   # 1x1 [Cout, Cin, 1, 1] -> [Cin, Cout]
        return conv.weight[:, :, 0, 0].t()

    parts = {}
    for tag, layer in (("l20.", net.layer20), ("l22.", net.layer22)):
        parts.update({f"{tag}win": pw(layer.cv_in.conv), f"{tag}bin": layer.cv_in.conv.bias,
                      f"{tag}wout": pw(layer.cv_out.conv),
                      f"{tag}bout": layer.cv_out.conv.bias})
        for i in range(layer.depth):
            m = getattr(layer, f"m{i}")
            dw = m.dw.fused.conv
            parts.update({f"{tag}wexp{i}": pw(m.expand.conv),
                          f"{tag}bexp{i}": m.expand.conv.bias,
                          f"{tag}wdw{i}": dw.weight[:, 0].reshape(dw.out_channels, 25).t(),
                          f"{tag}bdw{i}": dw.bias, f"{tag}wproj{i}": pw(m.project.conv),
                          f"{tag}bproj{i}": m.project.conv.bias})
    layout = _layout(cfg)
    with torch.no_grad():
        for name, shape in layout:
            if tuple(parts[name].shape) != shape:
                raise ValueError(f"neck80_build: {name} is {tuple(parts[name].shape)}, "
                                 f"the config wants {shape}")
        flat = torch.cat([parts[n].float().reshape(-1) for n, _ in layout])
        # interleaved columns: the GEMM then stores 16 bytes a lane; widths
        # it does not take get no pack, and bf16 then raises
        mma = torch.cat([pack_b(parts[n].float(), interleave=True)
                         for n in _mma_names(cfg)]) if _mma_ok(cfg) \
            else flat.new_empty(0, dtype=torch.bfloat16)
    return Neck80Weights(cfg, flat.contiguous(), mma.contiguous())


def neck80_plain(x18, x4, x17u, nw: Neck80Weights, dtype=torch.float32):
    """Plain version: NHWC sources -> (y20, y22) NHWC, computed in f32 with
    ordinary convolutions (zero padding at every DW) and cast to `dtype`."""
    p = _unpack(nw)
    cfg = nw.cfg

    def pw(x, w, b):
        return F.silu(F.conv2d(x, w.t()[:, :, None, None], b))

    def rephdw(tag, xs, c_, mid, depth):
        x2 = pw(torch.cat(xs, 1), p[f"{tag}win"], p[f"{tag}bin"])
        outs = [x2[:, :c_], x2[:, c_:]]
        for i in range(depth):
            t = pw(outs[-1], p[f"{tag}wexp{i}"], p[f"{tag}bexp{i}"])
            wdw = p[f"{tag}wdw{i}"].t().reshape(mid, 1, 5, 5)
            t = F.silu(F.conv2d(t, wdw, p[f"{tag}bdw{i}"], padding=2, groups=mid))
            outs.append(pw(t, p[f"{tag}wproj{i}"], p[f"{tag}bproj{i}"]))
        return pw(torch.cat(outs, 1), p[f"{tag}wout"], p[f"{tag}bout"])

    x18, x4, x17u = (x.permute(0, 3, 1, 2).float() for x in (x18, x4, x17u))
    y20 = rephdw("l20.", [x18, x4, x17u], cfg.c1_, cfg.mid1, cfg.d1)
    y22 = rephdw("l22.", [y20, x17u], cfg.c2_, cfg.mid2, cfg.d2)
    return tuple(y.permute(0, 2, 3, 1).to(dtype) for y in (y20, y22))


def neck80_forward(x18, x4, x17u, nw: Neck80Weights, dtype=torch.float32):
    """Layers 19-22 of the deploy graph: NHWC [B,h,h,C_i] sources ->
    (y20 [B,h,h,c20], y22 [B,h,h,c22]) in `dtype`, f32 or bf16; the kernel
    accumulates in f32 and keeps its intermediates in `dtype` (bf16: bf16
    operands on the tensor cores; source widths in multiples of 16, the
    others of 32)."""
    xs = (x18, x4, x17u)
    cfg = nw.cfg
    b = x18.shape[0]
    want = [(b, cfg.h, cfg.h, c) for c in cfg.cins]
    if [tuple(x.shape) for x in xs] != want:
        raise ValueError(f"neck80_forward: want sources {want}, got "
                         f"{[tuple(x.shape) for x in xs]}")
    if any(x.dtype not in (torch.float32, torch.bfloat16) for x in xs) \
            or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("neck80_forward: f32 or bf16 only, got "
                         f"{[x.dtype for x in xs]} -> {dtype}")
    if x18.device.type == "cpu":
        return neck80_plain(x18, x4, x17u, nw, dtype)
    if x18.device.type != "cuda":
        raise RuntimeError(f"neck80_forward: unsupported device {x18.device}")
    dev = x18.device
    if any(x.device != dev for x in xs) or nw.flat.device != dev \
            or nw.flat.dtype != torch.float32 or nw.mma.device != dev \
            or nw.mma.dtype != torch.bfloat16:
        raise ValueError("neck80_forward: sources, f32 weights and the bf16 MMA pack "
                         "must share one device")
    if dtype == torch.bfloat16 and not _mma_ok(cfg):
        raise ValueError("neck80_forward: bf16 wants source widths in multiples of 16 "
                         f"and the others of 32, got {cfg}")
    lib = _build.load("neck80", _SIG)
    if lib.neck80_weight_len(*cfg.dims()) != nw.flat.numel() \
            or (_mma_ok(cfg) and sum(math.prod(s) for n, s in _layout(cfg)
                                     if n in _mma_names(cfg)) != nw.mma.numel()):
        raise ValueError("neck80_forward: packed weight length mismatch")
    xs = [x.to(dtype).contiguous() for x in xs]
    p = b * cfg.h * cfg.h

    def scratch(c):
        return torch.empty((p, c), dtype=dtype, device=dev)

    y20 = torch.empty((b, cfg.h, cfg.h, cfg.c20), dtype=dtype, device=dev)
    y22 = torch.empty((b, cfg.h, cfg.h, cfg.c22), dtype=dtype, device=dev)
    bufs = (y20, y22, scratch((2 + cfg.d1) * cfg.c1_), scratch((2 + cfg.d2) * cfg.c2_),
            scratch(max(cfg.mid1, cfg.mid2)), scratch(max(cfg.mid1, cfg.mid2)))
    fn = lib.neck80_f32 if dtype == torch.float32 else lib.neck80_bf16
    err = fn(*(x.data_ptr() for x in xs), nw.flat.data_ptr(), nw.mma.data_ptr(),
             *(t.data_ptr() for t in bufs), b, cfg.h, cfg.h, *cfg.dims(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "neck80 kernel")
    neck80_forward.launches += 1
    return y20, y22


neck80_forward.launches = 0
