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

The kernel computes the conv as a GEMM on the tensor cores: K = 32 rows of
byte pairs read straight from the image rows (`stem_gemm_rows`), the f32
weights scaled by a power of two and split into two fp16 parts
(`stem_gemm_weights`), packed in fragment order with each column group
permuted so that a lane stores neighbouring channels (`stem_pack`).
`stem_gemm_plain` is that formulation in plain tensors; the card's main
path never calls it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops._mma_pack import pack_b

_SIG = {"stem_run": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2}

# A band is ROWS output rows by at most COLS output columns (a whole row of a
# 640-px image), and BLOCKS_PER_SM blocks an SM walk the bands: the last line
# of `python -m mafyolo_tpu_torch.tools.tune_kernels stem`.
ROWS, COLS, BLOCKS_PER_SM = 4, 320, 4
SPLITS = 2     # fp16 parts of each scaled weight: hi, lo


@dataclasses.dataclass(frozen=True)
class StemWeights:
    flat: torch.Tensor   # f32 [27*O + O]: kernel HWIO [3,3,3(BGR),O] / 255, then bias

    @property
    def cout(self) -> int:
        return self.flat.numel() // 28

    @functools.cached_property
    def mma(self):
        """(the kernel's fp16 weight pack, its scale exponent): `stem_pack`,
        built once."""
        return stem_pack(self)


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


def stem_gemm_rows() -> list:
    """For each of the kernel's K = 32 rows, the tap (dy*9 + dx*3 + c) it
    carries, or -1 for a zero row. Rows 2p, 2p + 1 are byte pair p = 5*dy + i
    of input row dy: bytes 6x - 4 + 2i and 6x - 3 + 2i of pixel x, i.e. taps
    j = 2i - 1 and 2i of the 9-byte run 6x - 3 .. 6x + 5 (j = dx*3 + c);
    j = -1 and pair 15 carry no tap."""
    rows = []
    for p in range(16):
        for e in range(2):
            dy, i = divmod(p, 5)
            j = 2 * i - 1 + e
            rows.append(dy * 9 + j if p < 15 and j >= 0 else -1)
    return rows


def stem_gemm_weights(sw: StemWeights):
    """(f32 [SPLITS, 32, O], s): the weights in the kernel's K order, scaled
    by 2^s (the largest just under 2^15, inside fp16's range) and split into
    fp16 parts hi = fp16(w) and lo = fp16(w - hi) (the difference exact in
    f32), held as f32. hi + lo is within 2^-22 of the scaled weight
    (relative) or 2^-25 (absolute, where lo is subnormal)."""
    o = sw.cout
    w = sw.flat[:27 * o].view(27, o).float()
    top = w.abs().max().item()
    s = 15 - math.frexp(top)[1] if top > 0 else 0
    taps = torch.cat([w * 2.0 ** s, torch.zeros(1, o, dtype=torch.float32, device=w.device)])
    w = taps[torch.tensor(stem_gemm_rows(), device=w.device)]   # -1 -> the zero row
    hi = w.half().float()
    return torch.stack([hi, (w - hi).half().float()]), s


def stem_column_order(o: int) -> torch.Tensor:
    """perm[v] = the output channel that the kernel's MMA column v computes,
    or -1 (a zero column). Columns go in groups of 32, the last one 16 wide
    when O % 32 == 16 and otherwise 32 wide with zero columns past O; inside
    a group of 8*nt columns, MMA column 8j + 2t + e (N tile j, lane t's
    pair) computes channel 2*nt*t + 2j + e, so a lane's accumulators are
    2*nt neighbouring channels."""
    perm = []
    for c0 in range(0, o, 32):
        nt = 2 if o - c0 == 16 else 4
        for v in range(8 * nt):
            j, t, e = v // 8, v % 8 // 2, v % 2
            c = c0 + 2 * nt * t + 2 * j + e
            perm.append(c if c < o else -1)
    return torch.tensor(perm)


def stem_pack(sw: StemWeights):
    """(fp16 [SPLITS * 32 * columns], s): each part of `stem_gemm_weights`
    with its columns in `stem_column_order`, in mma_bf16.cuh's fragment
    order (`_mma_pack.pack_b`), and the scale exponent."""
    parts, s = stem_gemm_weights(sw)
    parts = torch.cat([parts, torch.zeros_like(parts[..., :1])], -1)   # column -1: zeros
    perm = stem_column_order(sw.cout).to(parts.device)
    return torch.cat([pack_b(p[:, perm], dtype=torch.float16) for p in parts]).contiguous(), s


def stem_gemm_plain(imgs_u8, sw: StemWeights, dtype=torch.float32):
    """The kernel's formulation in plain tensors: the K = 32 byte pairs of
    every output pixel gathered from the image rows (zeros for row -1 and
    bytes before the row), times the hi part onto the scaled bias and the lo
    part beside it, in f32, scaled back, ReLU. Pins what the kernel
    computes; nothing on the card's main path calls it."""
    _check_shape(imgs_u8)
    b, h, w, _ = imgs_u8.shape
    o, h2 = sw.cout, h // 2
    rows = F.pad(imgs_u8.reshape(b, h, 3 * w).float(), (4, 4, 1, 0))
    # input row 2y + dy - 1 sits at padded row 2y + dy; a 10-byte window at
    # padded byte 6x holds pairs i = 0..4 of pixel x
    a = torch.cat([rows[:, dy:dy + 2 * h2:2].unfold(2, 10, 6) for dy in range(3)], -1)
    a = F.pad(a, (0, 2))
    (hi, lo), s = stem_gemm_weights(sw)
    y = (sw.flat[27 * o:].float() * 2.0 ** s + a @ hi) + a @ lo
    return F.relu(y * 2.0 ** -s).to(dtype)


def _launch(imgs_u8, sw: StemWeights, dtype, rows: int, blocks_per_sm: int, prof=None):
    """One launch of the kernel on checked, contiguous inputs with the given
    band height and blocks an SM; prof is None or 4 int64 on the card that
    gather the clocks by phase. Counts no launch."""
    b, h, w, _ = imgs_u8.shape
    o = sw.cout
    out = torch.empty((b, h // 2, w // 2, o), dtype=dtype, device=imgs_u8.device)
    if out.numel() == 0:
        return out
    cols = min(-(-(w // 2) // 16) * 16, COLS)
    bands = b * -(-(h // 2) // rows) * -(-(w // 2) // cols)
    blocks = min(bands, blocks_per_sm * _build.sm_count(imgs_u8.device.index))
    pack, scale_exp = sw.mma
    lib = _build.load("stem", _SIG)
    err = lib.stem_run(imgs_u8.data_ptr(), pack.data_ptr(), sw.flat.data_ptr(),
                       out.data_ptr(), b, h, w, o, int(dtype == torch.bfloat16), scale_exp,
                       rows, cols, blocks, None if prof is None else prof.data_ptr(),
                       _build.current_stream(imgs_u8.device))
    _build.check(lib, err, "stem kernel")
    return out


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
    out = _launch(imgs_u8.contiguous(), sw, dtype, ROWS, BLOCKS_PER_SM)
    if out.numel():
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
