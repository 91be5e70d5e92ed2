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
the activations are quantized where they are loaded. `int8_conv` and
`int8_dw` call the custom ops `mafyolo::int8_conv` and `mafyolo::int8_dw`
(registered when this module is imported; they take the pack's tensors and
scalars, and their fake versions give the output's shape, so torch.export
records them in a program), which run the plain version on a CPU tensor
and the kernel on a CUDA tensor; there is no fallback from one to the
other. `act` is the activation that follows the
conv in the graph: the dense kernel applies ReLU and SiLU in its epilogue
(FUSED_ACTS), on the CPU torch applies it after the plain version, with the
same bits (chip_smoke.py checks every site and every finite bf16 value for
SiLU). Beside the plain version sit the kernels' formulations in int64 on
the CPU, which the tests hold to it: int8_conv_gemm_plain (the dense GEMM
and its fragment pack), int8_conv_window_plain (the dense kernel block by
block: its windows, slots and K walk) and int8_dw_words_plain (the
depthwise kernel's tiles and packed-word rows), and the tile planners both
kernels take their tiles from (conv_tile, dw_tile). The plain version's integer conv is exact:
an f64 conv of the integer-valued operands (every |sum| <= 127^2 * K <
2^53), on the CPU as on the card (torch's int64 CPU conv takes the same
sums 3-7x slower; tests/test_torch_quant_conv.py holds both to an int64
ground truth).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops._mma_pack import pack_b_s8, pad16, pad32, unpack_b_s8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG_CONV = {"int8_conv": [_P, _P, _P, _P, _P] + [_I] * 15 + [_F, _I, _I, _P, _P]}
_SIG_DW = {"int8_dw": [_P, _P, _P, _P, _P] + [_I] * 8 + [_F, _I, _P, _P]}
DW_KERNELS = (3, 5, 7, 9)
QMAX = 127.0
# The activations the dense kernel applies in its epilogue, bit for bit as
# torch does after it (chip_smoke.py checks every site and, for SiLU, every
# finite bf16 value); any other runs after the kernel.
FUSED_ACTS = ("relu", "silu")
_ACT_CODE = {None: 0, "relu": 1, "silu": 2}
BM = 64                     # output pixels a block of the dense kernel
SMEM_LIMIT = 227 * 1024     # shared memory a block may use on the H100
# The depthwise kernel's tile side by kernel size, for images larger than
# DW_WHOLE pixels (smaller ones take one whole image a block where it fits).
# N's sites are k 3 at 160 px, k 5 at 80, k 7 at 40 and k 9 at 20; read from
# `tools/tune_kernels.py int8`'s cold sweep (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §6): k 3 32 (16: +22%), k 5 40 (16: +10%), whole 40 and 20 px
# images at k 7 and 9 (20: +32%, 12: +77%). k 7 and 9 keep 16 for larger
# images, which N does not have.
DW_TILE = {3: 32, 5: 40, 7: 16, 9: 16}
DW_WHOLE = 40 * 40


@dataclasses.dataclass
class Int8Pack:
    """One conv's int8 weights and epilogue, packed once on the host.

    kind "dense" (groups 1: w_kernel holds the [K, O] weight, K ordered
    (ky, kx, c) with the channels of each tap padded with zero rows to
    pad16(C) and K to a multiple of 32, in mma.m16n8k32 fragment order) or
    "dw" (depthwise, stride 1, 'same' pad: w_kernel int32 [k, G, C], G =
    ceil(k / 4): row ky of channel c as G words of 4 signed bytes, tap
    4g + j in byte j, zero past k).
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
        g4 = -(-k // 4)
        rows = F.pad(w_q.reshape(o, k, k), (0, 4 * g4 - k))          # [C, ky, 4G]
        w_kernel = rows.reshape(o, k, g4, 4).permute(1, 2, 0, 3).contiguous() \
            .view(torch.int32).reshape(-1).reshape(k, g4, o)         # [k, G, C]
    elif groups == 1 and k == k2:
        kind = "dense"
        taps = F.pad(w_q.permute(2, 3, 1, 0), (0, 0, 0, pad16(i) - i))   # [k, k, cp, O]
        w_kernel = pack_b_s8(taps.reshape(k * k * pad16(i), o))
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
    """The dense kernel's GEMM: rows are output pixels, K the (ky, kx, c)
    taps of the quantized input with each tap's channels padded to
    pad16(C) and K to 32, columns the output channels of the fragment pack
    read back (unpack_b_s8); int64 on the CPU."""
    if p.kind != "dense":
        raise ValueError("int8_conv_gemm_plain: dense convs only")
    b, c, h, w = x.shape
    k, s, pad, cp = p.k, p.stride, p.pad, pad16(c)
    ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
    xq = F.pad(quantize(x, p.x_scale_t).to(torch.int64).permute(0, 2, 3, 1),
               (0, cp - c, pad, pad, pad, pad))             # [B, H+2p, W+2p, cp]
    taps = [xq[:, ky:ky + s * (ho - 1) + 1:s, kx:kx + s * (wo - 1) + 1:s]
            for ky in range(k) for kx in range(k)]
    a = torch.cat(taps, -1).reshape(b * ho * wo, k * k * cp)
    a = F.pad(a, (0, pad32(k * k * cp) - k * k * cp))
    wmat = unpack_b_s8(p.w_kernel.cpu(), k * k * cp, p.cout).to(torch.int64)
    acc = (a @ wmat)[:, :p.cout].reshape(b, ho, wo, p.cout).permute(0, 3, 1, 2)
    return _epilogue(acc, p, x.dtype)


def _pitch(cp: int) -> int:
    """Bytes between the dense kernel's window slots: an odd multiple of 16,
    so that the 8 rows of an ldmatrix phase fall on distinct banks."""
    return cp if (cp // 16) % 2 else cp + 16


def conv_tile(k: int, stride: int, pad: int, ho: int, wo: int, cp: int, esize: int):
    """(th, tw): the dense kernel's tile of output pixels of one image, th *
    tw <= BM; (0, 0) for a 1x1 stride-1 conv, whose block takes BM
    consecutive pixels. The fewest blocks first (the most real rows of the
    BM a block computes: 20 x 3 at 20 px), then the smallest window; the
    window and the output stage must fit in SMEM_LIMIT."""
    if k == 1 and stride == 1 and pad == 0:
        return 0, 0
    best = None
    for tw in sorted({64, 32, 16, 8, 4, 2, 1} | ({wo} if wo < BM else set())):
        th = BM // tw
        wh, ww = (th - 1) * stride + k, (tw - 1) * stride + k
        slots = wh * stride * -(-ww // stride)
        if slots * _pitch(cp) + BM * (64 * esize + 16) > SMEM_LIMIT:
            continue
        key = (-(-ho // th) * -(-wo // tw), wh * ww, -tw)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    if best is None:
        raise ValueError(f"int8_conv: no tile of a {k}x{k} conv over {cp}-byte pixels fits "
                         f"in {SMEM_LIMIT} bytes of shared memory")
    return best[1]


def int8_conv_window_plain(x: torch.Tensor, p: Int8Pack, tile=None, seed: int = 0):
    """The dense kernel's formulation block by block, int64 on the CPU: each
    block's window of quantized pixels (slots of pitch _pitch(cp), columns
    grouped by parity of the stride, zero outside the image, every other byte
    random, as the kernel leaves it), the A operand read from it at the
    (slot, byte) each lane addresses as the kernel walks K, times the weight
    read back from its fragment pack. tile=None takes conv_tile's."""
    if p.kind != "dense":
        raise ValueError("int8_conv_window_plain: dense convs only")
    gen = torch.Generator().manual_seed(seed)
    xq = quantize(x, p.x_scale_t).to(torch.int64).permute(0, 2, 3, 1)    # [B, H, W, C]
    b, h, w, c = xq.shape
    k, s, pad, o = p.k, p.stride, p.pad, p.cout
    ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
    cp = pad16(c)
    pitch, kp = _pitch(cp), pad32(k * k * cp)
    th, tw = conv_tile(k, s, pad, ho, wo, cp, x.element_size()) if tile is None else tile
    wmat = unpack_b_s8(p.w_kernel.cpu(), k * k * cp, o).to(torch.int64)
    # what each K index reads: the 16-byte chunk of its lane, (tap, channel)
    kk = torch.arange(kp)
    tap, cc = (kk // 16 * 16) // cp, (kk // 16 * 16) % cp + kk % 16
    real = tap < k * k
    ky, kx = tap // k, tap % k
    byte = torch.where(real, cc, kk % 16)
    acc = torch.zeros((b * ho * wo, o), dtype=torch.int64)

    def gemm(win, base):
        toff = ky * srow + (kx % s) * wws + kx // s
        slot = torch.where(real[None], base[:, None] + toff[None], 0)
        return win[slot, byte[None].expand_as(slot)] @ wmat

    rows = torch.arange(BM)
    if th == 0:
        srow = wws = 0
        flat = xq.reshape(-1, c)
        for m0 in range(0, b * h * w, BM):
            n = min(BM, b * h * w - m0)
            win = torch.randint(-128, 128, (BM, pitch), generator=gen)
            win[:n, :c] = flat[m0:m0 + n]
            acc[m0:m0 + n] = gemm(win, rows)[:n, :o]
        return _epilogue(acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2), p, x.dtype)
    wh, ww = (th - 1) * s + k, (tw - 1) * s + k
    wws = -(-ww // s)
    srow = s * wws
    wy, wx = torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij")
    wslot = (wy * s + wx % s) * wws + wx // s
    base = torch.where(rows < th * tw, (rows // tw) * s * srow + rows % tw, 0)
    for bi in range(b):
        for oy0 in range(0, ho, th):
            for ox0 in range(0, wo, tw):
                iy, ix = oy0 * s - pad + wy, ox0 * s - pad + wx
                inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                win = torch.randint(-128, 128, (wh * srow, pitch), generator=gen)
                win[wslot.flatten(), :c] = 0
                win[wslot[inside], :c] = xq[bi, iy[inside], ix[inside]]
                got = gemm(win, base)[:, :o]
                oy, ox = oy0 + rows // tw, ox0 + rows % tw
                keep = (rows < th * tw) & (oy < ho) & (ox < wo)
                acc[(bi * ho + oy[keep]) * wo + ox[keep]] = got[keep]
    return _epilogue(acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2), p, x.dtype)


def _dw_smem(k: int, th: int, tw: int, cg: int, esize: int) -> int:
    """Shared memory of a depthwise block (csrc/int8_dw.cu): the channel
    planes and the output tile."""
    nrg, nxg = -(-th // 4), -(-tw // 4)
    wh, nwr = 4 * nrg + k - 1, -(-(4 * nxg + k - 1) // 4) + 1
    plane = wh * nwr + (32 // cg - wh * nwr) % 32
    return cg * plane * 4 + th * tw * cg * esize


def dw_tile(k: int, h: int, w: int, c: int, esize: int):
    """(th, tw): the depthwise kernel's tile, the whole image up to DW_WHOLE
    pixels where its block fits in shared memory, else DW_TILE[k] a side."""
    cg = 16 if c % 16 == 0 else 8
    if h * w <= DW_WHOLE and _dw_smem(k, h, w, cg, esize) <= SMEM_LIMIT:
        return h, w
    return min(DW_TILE[k], h), min(DW_TILE[k], w)


def int8_dw_words_plain(x: torch.Tensor, p: Int8Pack, tile=None) -> torch.Tensor:
    """The depthwise kernel's formulation tile by tile, int64 on the CPU:
    each tile's window of quantized bytes (zero outside the image) covering
    4 x 4 output groups and the words its funnel shifts read past them; an
    output is the sum over rows ky and words g of the dot product of the
    4 bytes at column ox + 4g + j (j = 0..3) with the weight word (ky, g) of
    the pack, whose taps past k are zero. tile=None takes dw_tile's."""
    if p.kind != "dw":
        raise ValueError("int8_dw_words_plain: depthwise convs only")
    xq = quantize(x, p.x_scale_t).to(torch.int64)                       # [B, C, H, W]
    b, c, h, w = xq.shape
    k, half = p.k, p.k // 2
    g4 = -(-k // 4)
    wt = p.w_kernel.cpu().contiguous().view(torch.int8).reshape(k, g4, c, 4) \
        .permute(0, 1, 3, 2).reshape(k, 4 * g4, c).to(torch.int64)   # [ky, tap, C]
    th, tw = dw_tile(k, h, w, c, x.element_size()) if tile is None else tile
    nrg, nxg = -(-th // 4), -(-tw // 4)
    wh, nwr = 4 * nrg + k - 1, -(-(4 * nxg + k - 1) // 4) + 1
    oy, ox = torch.arange(4 * nrg), torch.arange(4 * nxg)
    acc = torch.zeros_like(xq)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            iy, ix = y0 - half + torch.arange(wh), x0 - half + torch.arange(4 * nwr)
            win = torch.zeros((b, c, wh, 4 * nwr), dtype=torch.int64)
            vy, vx = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
            win[:, :, vy.nonzero()[:, 0][:, None], vx.nonzero()[:, 0][None]] = \
                xq[:, :, iy[vy][:, None], ix[vx][None]]
            tile_acc = torch.zeros((b, c, 4 * nrg, 4 * nxg), dtype=torch.int64)
            for ky in range(k):
                for t in range(4 * g4):
                    tile_acc += win[:, :, (oy + ky)[:, None], (ox + t)[None]] \
                        * wt[ky, t][None, :, None, None]
            ny, nx = min(th, h - y0), min(tw, w - x0)
            acc[:, :, y0:y0 + ny, x0:x0 + nx] = tile_acc[:, :, :ny, :nx]
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


ACTS = {None: lambda y: y, "relu": F.relu, "silu": F.silu}


def int8_conv(x: torch.Tensor, p: Int8Pack, act=None) -> torch.Tensor:
    """Real-int8 conv of one deploy-graph conv, then the activation `act`
    (None, "relu" or "silu"); routes a "dw" pack to int8_dw. See the module
    docstring for the contract. Calls the op `mafyolo::int8_conv` on the
    pack's tensors, so that torch.export records the op in a program."""
    if act not in ACTS:
        raise ValueError(f"int8_conv: unknown activation {act!r}")
    if p.kind == "dw":
        return ACTS[act](int8_dw(x, p))
    return torch.ops.mafyolo.int8_conv(x, p.w_q, p.w_kernel, p.scale, p.bias, p.x_scale_t,
                                       p.x_scale, p.stride, p.pad, act)


def _out_hw(h: int, w: int, k: int, stride: int, pad: int):
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def _int8_conv_impl(x: torch.Tensor, w_q: torch.Tensor, w_kernel: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, x_scale_t: torch.Tensor,
                  x_scale: float, stride: int, pad: int, act: Optional[str]) -> torch.Tensor:
    """The op `mafyolo::int8_conv`: a dense (groups 1) pack's tensors (w_q
    the OIHW int8 weight of the plain version, w_kernel the kernel's
    fragment pack, scale, bias, x_scale_t) and its scalars. The plain
    version (then torch's activation) on a CPU tensor, the kernel with the
    activation in its epilogue on a CUDA tensor, a raise on any other device."""
    o, i, k, _ = w_q.shape
    p = Int8Pack("dense", i, o, k, stride, pad, 1, x_scale, x_scale_t, w_q, w_kernel, scale,
                 bias)
    if x.device.type == "cpu":
        return ACTS[act](int8_conv_plain(x, p))
    _launch_checks(x, p, "int8_conv")
    fuse = act in FUSED_ACTS
    out = conv_launch(x, p, act if fuse else None)
    int8_conv.launches += 1
    return out if fuse else ACTS[act](out)


_int8_conv_op = torch.library.custom_op("mafyolo::int8_conv", _int8_conv_impl, mutates_args=())


@_int8_conv_op.register_fake
def _(x, w_q, w_kernel, scale, bias, x_scale_t, x_scale, stride, pad, act):
    ho, wo = _out_hw(x.shape[2], x.shape[3], w_q.shape[2], stride, pad)
    return torch.empty((x.shape[0], w_q.shape[0], ho, wo), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def conv_launch(x, p: Int8Pack, act=None, tile=None, prof=None):
    """One launch of the dense kernel on a checked CUDA input, the activation
    `act` (None or one of FUSED_ACTS) in its epilogue; tile overrides
    conv_tile's, prof is None or 4 int64 on the card that gather its clocks
    by phase. Counts no launch."""
    x, ld = _as_nhwc(x)
    b, c, h, w = x.shape
    ho, wo = _out_hw(h, w, p.k, p.stride, p.pad)
    out = torch.empty((b, p.cout, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if b * ho * wo >= 2 ** 31 or b * h * w * ld >= 2 ** 31:
        raise ValueError(f"int8_conv: {tuple(x.shape)} exceeds 32-bit indexing")
    cp = pad16(c)
    th, tw = tile or conv_tile(p.k, p.stride, p.pad, ho, wo, cp, x.element_size())
    lib = _build.load("int8_conv", _SIG_CONV)
    err = lib.int8_conv(x.data_ptr(), p.w_kernel.data_ptr(), p.scale.data_ptr(),
                        p.bias.data_ptr(), out.data_ptr(), b, h, w, c, ld, ho, wo,
                        p.cout, p.k, p.stride, p.pad, cp, pad32(p.k * p.k * cp), th, tw,
                        p.x_scale, _ACT_CODE[act], int(x.dtype == torch.bfloat16),
                        None if prof is None else prof.data_ptr(),
                        _build.current_stream(x.device))
    _build.check(lib, err, "int8_conv kernel")
    return out


def int8_dw(x: torch.Tensor, p: Int8Pack) -> torch.Tensor:
    """Real-int8 depthwise conv (stride 1, k in DW_KERNELS, 'same' pad)
    through the op `mafyolo::int8_dw`."""
    if p.kind != "dw":
        raise ValueError("int8_dw: want a depthwise pack")
    return torch.ops.mafyolo.int8_dw(x, p.w_q, p.w_kernel, p.scale, p.bias, p.x_scale_t,
                                     p.x_scale)


def _int8_dw_impl(x: torch.Tensor, w_q: torch.Tensor, w_kernel: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor, x_scale_t: torch.Tensor,
                x_scale: float) -> torch.Tensor:
    """The op `mafyolo::int8_dw`: a depthwise pack's tensors (w_q [C,1,k,k]
    int8, w_kernel the kernel's words) and x_scale. The plain version on a
    CPU tensor, the kernel on a CUDA tensor, a raise on any other device."""
    c, _, k, _ = w_q.shape
    p = Int8Pack("dw", c, c, k, 1, k // 2, c, x_scale, x_scale_t, w_q, w_kernel, scale, bias)
    if x.device.type == "cpu":
        return int8_conv_plain(x, p)
    _launch_checks(x, p, "int8_dw")
    out = dw_launch(x, p)
    int8_dw.launches += 1
    return out


_int8_dw_op = torch.library.custom_op("mafyolo::int8_dw", _int8_dw_impl, mutates_args=())


@_int8_dw_op.register_fake
def _(x, w_q, w_kernel, scale, bias, x_scale_t, x_scale):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def dw_launch(x, p: Int8Pack, tile=None, prof=None):
    """One launch of the depthwise kernel on a checked CUDA input; tile
    overrides dw_tile's, prof is None or 3 int64 on the card that gather its
    clocks by phase. Counts no launch."""
    x, ld = _as_nhwc(x)
    b, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if b > 65535 or b * h * w * ld >= 2 ** 31:
        raise ValueError(f"int8_dw: {tuple(x.shape)} exceeds the grid or 32-bit indexing")
    th, tw = tile or dw_tile(p.k, h, w, c, x.element_size())
    lib = _build.load("int8_dw", _SIG_DW)
    err = lib.int8_dw(x.data_ptr(), p.w_kernel.data_ptr(), p.scale.data_ptr(),
                      p.bias.data_ptr(), out.data_ptr(), b, h, w, c, ld, p.k, th, tw,
                      p.x_scale, int(x.dtype == torch.bfloat16),
                      None if prof is None else prof.data_ptr(),
                      _build.current_stream(x.device))
    _build.check(lib, err, "int8_dw kernel")
    return out


int8_conv.launches = 0
int8_dw.launches = 0
