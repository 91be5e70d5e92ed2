"""Depthwise-conv weight gradient: the CUDA kernel (csrc/dw_grad.cu) and its
plain PyTorch version.

Counterpart of mafyolo_tpu/ops/dw_grad_pallas.py (dw_grad_planar and
dw_grad_kernel, one sum) and of the K^2 unrolled taps that
mafyolo_tpu/ops/dwconv.py:_bwd_rule runs by default:

    dk[c, 0, ky, kx] = sum_{b,h,w} x_pad[b, c, h + ky*d, w + kx*d] * g[b, c, h, w]

Tensors are NCHW-shaped with channels-last memory (the port runs
channels_last, so NHWC is the physical layout, as in the JAX package).
`dw_grad` runs the plain version on a CPU tensor and the kernel on a CUDA
tensor; there is no fallback from one to the other. `plan` cuts a call into
tiles for the kernel: pure arithmetic on the shape, testable without a card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mafyolo_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"dw_grad": [_P, _P, _P, _P] + [_I] * 15 + [_P],
        "dw_grad_prof": [_P, _P, _P, _P] + [_I] * 15 + [_P, _P],   # + clocks per phase
        "dw_grad_reduce": [_P, _P, _I, _I, _I, _P],     # the second launch alone
        "dw_grad_smem": [_I] * 6}      # returns bytes, not an error code
KERNEL_SIZES = (1, 3, 5, 7, 9)
# The kernel's geometry (csrc/dw_grad.cu): a block is WARPS warps of 32 lanes,
# a lane owns cpt (1 or 2) channels, so a block owns 32 * cpt; a warp's
# register run is RUN output columns.
LANES, WARPS, RUN = 32, 8, 10
PHASES = ("issue_copies", "wait_copies", "multiply", "epilogue")
SMEM_LIMIT = 232448        # bytes a block may ask for on the H100
SMEM_PER_SM = 233472       # bytes all co-resident blocks share, 1 KB reserved each
STAGES, BARRIER_BYTES = 2, 128     # staged tiles a block holds; their barriers
BOX_LIMIT = 256            # rows or columns one tensor copy may bring
# The output tile (rows, columns) of each kernel size: the one with the least
# summed time over MAF-YOLO-N's train sites at bs32 in bf16 on an H100, from
# the tuning tool's sweep (python -m mafyolo_tpu_torch.tools.tune_kernels
# dw_grad all). Strips of 8 rows at every image size: a 20 px image is cut
# 8 + 8 + 4, and whole-image tiles were no faster.
TILE = {1: (8, 20), 3: (8, 20), 5: (8, 40), 7: (8, 20), 9: (8, 20)}


def forms(k: int, dilation: int):
    """The channels-per-lane values the kernel is built for: two only at
    k = 3, where 18 sums a lane leave the registers for it."""
    return (1, 2) if dilation == 1 and k == 3 else (1,)


class Plan(NamedTuple):
    """How one call is cut: streaming (k = 1: no tile, n_split blocks over the
    pixels) or th x tw output tiles (tw a multiple of the register run) walked
    by n_split blocks per group of 32 * cpt channels; smem is the tile
    kernel's request in bytes."""
    streaming: bool
    th: int
    tw: int
    cpt: int
    n_split: int
    smem: int


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def smem_bytes(k: int, dilation: int, th: int, tw: int, elem: int, cpt: int) -> int:
    """Shared memory of one block: the barriers and STAGES staged x tiles
    (with halo) and g tiles, or the warps' sums at the end (mirrors
    csrc/dw_grad.cu:smem_bytes)."""
    halo = (k - 1) * dilation
    ct = LANES * cpt
    stage = _round128((th + halo) * (tw + halo) * ct * elem) + _round128(th * tw * ct * elem)
    return max(BARRIER_BYTES + STAGES * stage, WARPS * k * k * ct * 4)


def tiles(p: Plan, ho: int, wo: int):
    """[(h0, h1, w0, w1)]: the output rows and columns of each tile of one
    image, in the kernel's tile order."""
    return [(h0, min(h0 + p.th, ho), w0, min(w0 + p.tw, wo))
            for h0 in range(0, ho, p.th) for w0 in range(0, wo, p.tw)]


def cut(b: int, c: int, ho: int, wo: int, k: int, dilation: int, elem: int, sms: int,
        th: int, tw: int, cpt: int) -> Plan:
    """The Plan of th x tw tiles (tw rounded up to whole runs) with cpt
    channels a lane: as many blocks a channel group as the card holds at
    once (the kernel's register budget allows 3 an SM, 2 from 49 sums a
    lane; shared memory may allow fewer), and none without a tile."""
    tw = -(-tw // RUN) * RUN
    smem = smem_bytes(k, dilation, th, tw, elem, cpt)
    per_sm = max(1, min(2 if k * k * cpt >= 49 else 3, SMEM_PER_SM // (smem + 1024)))
    groups = -(-c // (LANES * cpt))
    n_tiles = b * -(-ho // th) * -(-wo // tw)
    return Plan(False, th, tw, cpt, max(1, min(n_tiles, sms * per_sm // groups)), smem)


@functools.lru_cache(maxsize=None)
def plan(b: int, c: int, ho: int, wo: int, k: int, pad: int, dilation: int,
         elem: int, sms: int, aligned: bool = True) -> Plan:
    """Pick the cut for x [b, c, ., .] -> g [b, c, ho, wo] with elements of
    `elem` bytes on a card of `sms` SMs. Pure arithmetic on the shape, so the
    same shape on the same card always gives the same cut (and the same
    bits). k = 1 without padding streams; else the tile of TILE[k], clipped
    to the image, made narrower and then lower until two blocks fit on an SM
    and a tensor copy can bring it (a dilation whose smallest tile still
    exceeds a block's shared memory keeps that tile, and the launch
    raises). aligned: x and g start on 16-byte addresses, which the
    streaming kernel's loads need."""
    chunk = 16 // elem
    if aligned and k == 1 and pad == 0 and c % chunk == 0 and c // chunk <= LANES * WARPS:
        rows = LANES * WARPS // (c // chunk)          # pixels a block reads at once
        n_split = max(1, min(4 * sms, -(-b * ho * wo // (4 * rows))))
        return Plan(True, 1, 1, 1, n_split, 0)
    halo = (k - 1) * dilation
    cpt = 2 if 2 in forms(k, dilation) and c > LANES else 1
    th, tw = min(TILE[k][0], ho), min(TILE[k][1], -(-wo // RUN) * RUN)

    def too_large(th, tw):
        return (smem_bytes(k, dilation, th, tw, elem, cpt) > SMEM_LIMIT // 2
                or th + halo > BOX_LIMIT or tw + halo > BOX_LIMIT)
    while too_large(th, tw) and (th, tw) != (1, RUN):
        if tw > 2 * RUN:
            tw = 2 * RUN
        elif th > 1:
            th = -(-th // 2)
        else:
            tw = RUN
    return cut(b, c, ho, wo, k, dilation, elem, sms, th, tw, cpt)


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


def _launch(x, g, k: int, pad: int, dilation: int, p: Plan | None, prof=None):
    """Check the arguments, cut the call (p, or the planner's cut when p is
    None) and launch the kernel."""
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
    if p is None:
        p = plan(b, c, ho, wo, k, pad, dilation, x.element_size(),
                 _build.sm_count(x.device.index),
                 aligned=not (x.data_ptr() % 16 or g.data_ptr() % 16))
    part = _build.scratch(x.device, p.n_split * k * k * c * 4)
    lib = _build.load("dw_grad", _SIG)
    args = (x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), b, h, w, c, ho, wo, k, pad, dilation,
            int(p.streaming), p.th, -(-p.tw // RUN) * RUN, p.cpt, p.n_split,
            _build.current_stream(x.device))
    err = lib.dw_grad(*args) if prof is None else lib.dw_grad_prof(*args, prof.data_ptr())
    _build.check(lib, err, "dw_grad kernel")
    dw_grad.launches += 1
    return out


def dw_grad(x, g, k: int, pad: int, dilation: int = 1):
    """Depthwise weight gradient; see dw_grad_plain for the contract. On a CUDA
    tensor: f32 or bf16, channels-last memory, k in KERNEL_SIZES; a dilation
    whose smallest staged tile exceeds the block's shared memory raises from
    the kernel's launch."""
    if x.device.type == "cpu":
        return dw_grad_plain(x, g, k, pad, dilation)
    return _launch(x, g, k, pad, dilation, None)


dw_grad.launches = 0


def dw_grad_cut(x, g, k: int, pad: int, dilation: int, p: Plan, prof=None):
    """The kernel on CUDA tensors with the cut p instead of the planner's
    (the tuning tool's sweep and the card's tests; a width that is no whole
    number of runs is rounded up; a streaming cut is valid only where plan()
    would give one). `prof`, an int64 tensor of len(PHASES) counters on the
    card, receives the tile kernel's clocks per phase."""
    return _launch(x, g, k, pad, dilation, p, prof)
