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

Dense convs of k 3, stride 1, pad 1 (the office graphs' RepVGG and head
convs; `is_3x3s1`) take a kernel of their own, csrc/int8_conv3x3.cuh, built
into the same library: warpgroup MMA over a channel-blocked window quantized
once, the weights staged by tensor copies through an mbarrier ring. Their
pack's w_kernel is in that kernel's layout (pack_3x3), so the op's signature
is the same for both routes; plan3x3 gives the kernel's tiles, ring and
split, and int8_conv3x3_plain is its formulation tile by tile in int64 on
the CPU. Every other dense conv takes the windowed kernel of int8_conv.cu.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops._mma_pack import pack_b_s8, pad16, pad32, unpack_b_s8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG_CONV = {"int8_conv": [_P, _P, _P, _P, _P] + [_I] * 15 + [_F, _I, _I, _P, _P],
             "int8_conv3x3": [_P, _P, _P, _P, _P] + [_I] * 14 + [_F, _I, _I, _P, _P],
             "int8_conv3x3_load_path": [_P, _I, _I, _I]}
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
# The 3x3 stride-1 kernel (csrc/int8_conv3x3.cuh): the wgmma N widths it is
# built for, its ring (slots, 16-byte K chunks a slot) from the fastest down
# to what fits, and its output tile by output side (rows, columns, whether
# the two warpgroups split the N tile instead of the pixels), fastest first.
# Read from the last line of `tools/tune_kernels.py int8_3x3` (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md §6); RING3's last three are smaller slots for
# windows too large for the swept ones.
BNW3 = (128, 64, 32)
RING3 = ((3, 8), (4, 4), (6, 4), (4, 8), (6, 8), (2, 8), (8, 4), (3, 4), (2, 4), (2, 2))
TABLE3 = {20: ((8, 16, True), (16, 8, False), (32, 8, False), (8, 32, False),
               (16, 16, False), (8, 8, True)),
          40: ((8, 16, True), (16, 8, False), (8, 8, True), (16, 16, False), (32, 8, False),
               (8, 32, False)),
          80: ((16, 16, False), (32, 8, False), (8, 32, False), (16, 8, False), (8, 16, True),
               (8, 8, True))}
SMEM_PER_SM = 233472        # bytes all co-resident blocks of an SM share, 1 KB each reserved


@dataclasses.dataclass
class Int8Pack:
    """One conv's int8 weights and epilogue, packed once on the host.

    kind "dense" (groups 1: w_kernel holds the [K, O] weight, K ordered
    (ky, kx, c) with the channels of each tap padded with zero rows to
    pad16(C) and K to a multiple of 32, in mma.m16n8k32 fragment order; a
    3x3 stride-1 pad-1 conv in pack_3x3's layout instead) or
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


def is_3x3s1(k: int, stride: int, pad: int) -> bool:
    """A dense conv the 3x3 stride-1 kernel takes (by shape alone)."""
    return k == 3 and stride == 1 and pad == 1


def pack_3x3(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 [O, C, 3, 3] -> the 3x3 stride-1 kernel's weights, int8
    [K / 16, O, 16]: K = (ky, kx, c) with c padded with zeros to pad32(C);
    for each 16-byte chunk of K, every output channel's 16 bytes of it. A
    tensor copy of [kc, nb, 16] from it is kc K chunks of nb channels, each
    8 channels x 16 bytes one core matrix of the wgmma B operand."""
    o, c = w_q.shape[:2]
    taps = F.pad(w_q.permute(0, 2, 3, 1), (0, pad32(c) - c))        # [O, 3, 3, cp]
    return taps.reshape(o, 9 * pad32(c) // 16, 16).permute(1, 0, 2).contiguous()


def unpack_3x3(w_kernel: torch.Tensor, c: int) -> torch.Tensor:
    """pack_3x3's layout -> the OIHW int8 weight [O, c, 3, 3]."""
    o = w_kernel.shape[1]
    return w_kernel.permute(1, 0, 2).reshape(o, 9, -1)[:, :, :c].reshape(o, 3, 3, c) \
        .permute(0, 3, 1, 2).contiguous()


def w_kernel_shape(c: int, o: int, k: int, stride: int, pad: int):
    """The shape of a dense pack's int8 w_kernel in the layout of the route
    its site takes: pack_3x3's at a 3x3 stride-1 site, pack_b_s8's flat
    fragment pack at any other."""
    if is_3x3s1(k, stride, pad):
        return (9 * pad32(c) // 16, o, 16)
    return (pad32(k * k * pad16(c)) * pad16(o),)


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
    elif groups == 1 and k == k2 and is_3x3s1(k, stride, pad):
        kind = "dense"
        w_kernel = pack_3x3(w_q)
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
    if p.kind != "dense" or is_3x3s1(p.k, p.stride, p.pad):
        raise ValueError("int8_conv_gemm_plain: dense convs of the windowed kernel only, not 3x3 stride 1")
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
    if p.kind != "dense" or is_3x3s1(p.k, p.stride, p.pad):
        raise ValueError("int8_conv_window_plain: dense convs of the windowed kernel only, not 3x3 stride 1")
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


class Plan3(NamedTuple):
    """How the 3x3 stride-1 kernel cuts one call: th x tw output tiles of
    one image (multiples of 8: th tw / 64 sub-tiles of 8 x 8 pixels, the
    M = 64 rows of a wgmma), wgmma N bnw, the two warpgroups splitting each
    block's N tile (split_n: nb = 2 bnw channels, each warpgroup every
    sub-tile) or its sub-tiles (nb = bnw), n_split blocks sharing a pixel
    tile's N tiles, a ring of `stages` slots of kc 16-byte K chunks, and the
    block's shared memory in bytes."""
    th: int
    tw: int
    bnw: int
    split_n: bool
    n_split: int
    stages: int
    kc: int
    smem: int


def smem3x3(cp: int, th: int, tw: int, bnw: int, split_n: bool, stages: int, kc: int,
            esize: int) -> int:
    """Shared memory of one 3x3 stride-1 block (mirrors csrc/int8_conv3x3.cuh:
    int8_conv3x3_smem): the barriers, the ring, the window (cp bytes a
    pixel, 128-byte aligned) and two warpgroups' output stages (64 pixels
    of bnw elements plus 16 bytes)."""
    nb = bnw * (2 if split_n else 1)
    win = -(-(th + 2) * (tw + 2) * cp // 128) * 128
    return 128 + stages * nb * kc * 16 + win + 2 * 64 * (bnw * esize + 16)


def cut3x3(ho: int, wo: int, c: int, o: int, esize: int, b: int, sms: int, th: int, tw: int,
           split_n: bool, bnw: Optional[int] = None, ring=None) -> Optional[Plan3]:
    """The Plan3 of th x tw tiles (split_n as given): wgmma N bnw (None: the
    widest of BNW3 whose N tiles cover O with at most a quarter more
    channels), the ring `ring` (None: the first of RING3 whose block fits in
    SMEM_LIMIT), and, where the pixel tiles are fewer than two waves of the
    card's resident blocks (up to three an SM, as the kernel's registers and
    shared memory allow), n_split blocks sharing a tile's N tiles. None if
    the block does not fit, or holds more than 64 sums a thread (bnw times
    its mg sub-tiles over 128: the kernel is not built for it)."""
    cp = pad32(c)
    mg = th * tw // 64 // (1 if split_n else 2)
    if bnw is None:
        bnw = next((n for n in BNW3 if n * mg <= 128 and -(-o // (n * (1 + split_n)))
                    * n * (1 + split_n) <= 1.25 * o), BNW3[-1])
    if bnw * mg > 128:
        return None
    for stages, kc in (ring,) if ring else RING3:
        smem = smem3x3(cp, th, tw, bnw, split_n, stages, kc, esize)
        if smem <= SMEM_LIMIT:
            break
    else:
        return None
    ntn = -(-o // (bnw * (2 if split_n else 1)))
    tiles = b * -(-ho // th) * -(-wo // tw)
    per_sm = max(1, min(3 if bnw * mg <= 64 else 2, SMEM_PER_SM // (smem + 1024)))
    return Plan3(th, tw, bnw, split_n, max(1, min(ntn, -(-2 * sms * per_sm // tiles))), stages,
                 kc, smem)


@functools.lru_cache(maxsize=None)
def plan3x3(ho: int, wo: int, c: int, o: int, esize: int, b: int = 1, sms: int = 132) -> Plan3:
    """The Plan3 of a 3x3 stride-1 conv with an ho x wo output (= input), c
    input and o output channels, esize-byte elements, b images, on a card
    of `sms` SMs. Pure arithmetic on the shape: the cut3x3 of the first tile
    of TABLE3 for the output's side whose block fits. Every plan gives the
    same bits (each block's sums are whole). Raises where no block fits."""
    side = min(ho, wo)
    for th, tw, split_n in TABLE3[20 if side <= 24 else 40 if side <= 48 else 80]:
        plan = cut3x3(ho, wo, c, o, esize, b, sms, th, tw, split_n)
        if plan is not None:
            return plan
    raise ValueError(f"int8_conv3x3: no tile of a 3x3 conv over {pad32(c)}-byte pixels fits "
                     f"in {SMEM_LIMIT} bytes of shared memory")


def int8_conv3x3_plain(x: torch.Tensor, p: Int8Pack, plan: Optional[Plan3] = None):
    """The 3x3 stride-1 kernel's formulation tile by tile, int64 on the CPU:
    each tile's window quantized once (zeros outside the image and past C)
    as the channel-blocked bytes [cp / 16][window pixel][16]; the weights as
    the tensor copies bring them, slot by slot ([kc, nb, 16] boxes of
    pack_3x3's layout, zeros past O and K); each K step's A and B read
    through the wgmma descriptors' rule (core matrices of 8 rows x 16 bytes,
    LBO between the two K halves, SBO between groups of 8 rows) at the
    start addresses the kernel gives them: the 9 taps as shifts of one
    window. Then the same epilogue. plan=None takes plan3x3's."""
    if p.kind != "dense" or not is_3x3s1(p.k, p.stride, p.pad):
        raise ValueError("int8_conv3x3_plain: dense 3x3 stride-1 pad-1 convs only")
    b, c, h, w = x.shape
    o, cp = p.cout, pad32(c)
    pl = plan or plan3x3(h, w, c, o, x.element_size(), b)
    th, tw, bnw, kc = pl.th, pl.tw, pl.bnw, pl.kc
    ww, wp = tw + 2, (th + 2) * (tw + 2)
    nty, ntx = -(-h // th), -(-w // tw)
    xq = quantize(x, p.x_scale_t).to(torch.int64).permute(0, 2, 3, 1)
    xp = torch.zeros((b, nty * th + 2, ntx * tw + 2, cp), dtype=torch.int64)
    xp[:, 1:h + 1, 1:w + 1, :c] = xq
    win = xp.unfold(1, th + 2, th).unfold(2, tw + 2, tw)          # [B, ty, tx, cp, wh, ww]
    win = win.reshape(-1, cp // 16, 16, wp).transpose(2, 3).reshape(-1, cp * wp)
    cs, ksteps = cp // 32, 9 * cp // 32
    nb = bnw * (2 if pl.split_n else 1)
    ntn, nsub = -(-o // nb), th * tw // 64
    mg = nsub if pl.split_n else nsub // 2
    kss = kc // 2
    nst = -(-ksteps // kss)
    lbo_a, sbo_a, lbo_b = wp * 16, ww * 16, nb * 16
    r, kb, n = torch.arange(64)[:, None], torch.arange(32)[None], torch.arange(bnw)[None]
    read_a = (r // 8) * sbo_a + (r % 8) * 16 + (kb // 16) * lbo_a + kb % 16      # [64, 32]
    read_b = (kb.T // 16) * lbo_b + (n // 8) * 128 + (n % 8) * 16 + kb.T % 16    # [32, bnw]
    # K step ks: slot ks // kss, its step ks % kss there; tap and channel block
    ks = torch.arange(ksteps)
    tap, c32 = ks // cs, ks % cs
    a0 = 2 * c32 * lbo_a + ((tap // 3) * ww + tap % 3) * 16
    read_ak = (a0[None, :, None] + read_a[:, None]).reshape(64, ksteps * 32)    # [64, K]
    # the weights as the copies bring them: zeros past O and past K
    wk = torch.zeros((nst * kc, ntn * nb, 16), dtype=torch.int64)
    wk[:9 * cp // 16, :o] = p.w_kernel.cpu().to(torch.int64)
    winf = win.double()            # f64 products and sums of bytes are exact (< 2^53)
    acc = torch.zeros((win.shape[0], nsub * 64, ntn * nb), dtype=torch.int64)
    for nt in range(ntn):
        slots = wk[:, nt * nb:(nt + 1) * nb].reshape(nst, kc * nb * 16)
        for wgi in range(2):
            n_wg = wgi * bnw if pl.split_n else 0
            read_bk = 2 * (ks % kss)[:, None, None] * lbo_b + n_wg * 16 + read_b[None]
            bk = slots[(ks // kss)[:, None, None].expand_as(read_bk), read_bk]
            bk = bk.reshape(ksteps * 32, bnw).double()
            for m in range(mg):
                idx = m if pl.split_n else wgi * mg + m
                sy, sx = divmod(idx, tw // 8)
                a = winf[:, (8 * sy * ww + 8 * sx) * 16 + read_ak]               # [T, 64, K]
                cols = slice(nt * nb + n_wg, nt * nb + n_wg + bnw)
                acc[:, idx * 64:(idx + 1) * 64, cols] += (a @ bk).to(torch.int64)
    q = torch.arange(nsub * 64)
    py = q // 64 // (tw // 8) * 8 + q % 64 // 8
    px = q // 64 % (tw // 8) * 8 + q % 8
    res = torch.zeros((b, nty, ntx, th, tw, o), dtype=torch.int64)
    res[:, :, :, py, px] = acc[..., :o].reshape(b, nty, ntx, nsub * 64, o)
    res = res.permute(0, 1, 3, 2, 4, 5).reshape(b, nty * th, ntx * tw, o)[:, :h, :w]
    return _epilogue(res.permute(0, 3, 1, 2), p, x.dtype)


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
    the OIHW int8 weight of the plain version, w_kernel the weights in the
    layout of the route the site takes (w_kernel_shape), scale, bias,
    x_scale_t) and its scalars. The plain version (then torch's activation)
    on a CPU tensor, the kernel with the activation in its epilogue on a
    CUDA tensor, a raise on any other device, and on any device a raise
    where w_kernel is not in its route's layout (a pack written for the
    other route)."""
    o, i, k, _ = w_q.shape
    want = w_kernel_shape(i, o, k, stride, pad)
    if w_kernel.dtype != torch.int8 or tuple(w_kernel.shape) != want:
        raise ValueError(f"int8_conv: w_kernel is {w_kernel.dtype} {tuple(w_kernel.shape)}, "
                         f"not the int8 {want} of a {k}x{k} stride-{stride} pad-{pad} site's "
                         f"route ({i} -> {o} channels): pack the weights again")
    p = Int8Pack("dense", i, o, k, stride, pad, 1, x_scale, x_scale_t, w_q, w_kernel, scale,
                 bias)
    if x.device.type == "cpu":
        return ACTS[act](int8_conv_plain(x, p))
    _launch_checks(x, p, "int8_conv")
    fuse = act in FUSED_ACTS
    if is_3x3s1(k, stride, pad):
        out = conv3x3_launch(x, p, act if fuse else None)
        int8_conv.launches_3x3 += 1
    else:
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


def conv3x3_launch(x, p: Int8Pack, act=None, plan: Optional[Plan3] = None, prof=None):
    """One launch of the 3x3 stride-1 kernel on a checked CUDA input, the
    activation `act` (None or one of FUSED_ACTS) in its epilogue; plan
    overrides plan3x3's, prof is None or 5 int64 on the card that gather its
    clocks by phase. Counts no launch."""
    x, ld = _as_nhwc(x)
    b, c, h, w = x.shape
    out = torch.empty((b, p.cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if b * h * w * max(ld, p.cout) >= 2 ** 31:
        raise ValueError(f"int8_conv3x3: {tuple(x.shape)} exceeds 32-bit indexing")
    pl = plan or plan3x3(h, w, c, p.cout, x.element_size(), b, _build.sm_count(x.device.index))
    lib = _build.load("int8_conv", _SIG_CONV)
    err = lib.int8_conv3x3(x.data_ptr(), p.w_kernel.data_ptr(), p.scale.data_ptr(),
                           p.bias.data_ptr(), out.data_ptr(), b, h, w, c, ld, p.cout, pad32(c),
                           pl.th, pl.tw, pl.bnw, int(pl.split_n), pl.n_split, pl.stages, pl.kc,
                           p.x_scale, _ACT_CODE[act], int(x.dtype == torch.bfloat16),
                           None if prof is None else prof.data_ptr(),
                           _build.current_stream(x.device))
    _build.check(lib, err, "int8_conv3x3 kernel")
    return out


def load_path3x3(x: torch.Tensor) -> int:
    """How the 3x3 stride-1 kernel stages x (a checked CUDA input, as
    conv3x3_launch passes it): 0 by 16-byte loads quantized by
    csrc/int8_conv3x3.cuh's Quant, 1 element by element (the library's own
    int8_conv3x3_load_path)."""
    x, ld = _as_nhwc(x)
    lib = _build.load("int8_conv", _SIG_CONV)
    return lib.int8_conv3x3_load_path(x.data_ptr(), x.shape[1], ld,
                                      int(x.dtype == torch.bfloat16))


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
int8_conv.launches_3x3 = 0      # the launches of them that took the 3x3 stride-1 kernel
int8_dw.launches = 0
