"""bf16 weight packs for the tensor-core kernels (csrc/mma_bf16.cuh).

A 1x1 conv's [K, N] weight is the B operand of `mma.m16n8k16`. `pack_b`
pads it with zeros to multiples of 16 both ways, casts it to bf16 (fp16
for the stem kernel) and lays it out in the order the kernels read whole
fragments: for each 16-row K tile, for each pair of 8-column N tiles, for
each lane (g = lane // 4, t = lane % 4), the 8 values
    B[2t, g], B[2t+1, g], B[2t+8, g], B[2t+9, g]   of the first N tile,
    the same four of the second.
`unpack_b` is its inverse (the padded [Kp, Np] matrix).

With `interleave` (N a multiple of 32) the columns of each group of 32 are
first permuted so that the 8 accumulator columns a lane holds over the four
N tiles of a 32-column warp tile (tile j, columns 2t and 2t + 1) are the 8
neighbouring real columns 8t .. 8t + 7: the kernel then stores a row's
results as one 16-byte word a lane.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def pad_rows(w: torch.Tensor, parts) -> torch.Tensor:
    """[sum(parts), N] -> each block of `parts` rows padded with zero rows to
    a multiple of 16 (one block per K segment the kernel walks)."""
    return torch.cat([F.pad(b, (0, 0, 0, pad16(b.shape[0]) - b.shape[0]))
                      for b in w.split(list(parts), 0)], 0)


def _interleave_perm(n: int) -> torch.Tensor:
    """perm[v] = the real column that sits at MMA column v."""
    if n % 32:
        raise ValueError(f"interleaved packs want N in multiples of 32, got {n}")
    v = torch.arange(n)
    j, t, e = v % 32 // 8, v % 8 // 2, v % 2
    return v // 32 * 32 + 8 * t + 2 * j + e


def pack_b(w: torch.Tensor, interleave: bool = False,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """f32 [K, N] -> flat bf16 (or `dtype`, fp16 for the stem)
    [pad16(K) * pad16(N)] in fragment order."""
    k, n = w.shape
    if interleave:
        w = w[:, _interleave_perm(n).to(w.device)]
    kp, np_ = pad16(k), pad16(n)
    w = F.pad(w.float(), (0, np_ - n, 0, kp - k)).to(dtype)
    # k = 16*kt + 8*half + 2*t + j ; n = 16*pair + 8*tile + g
    w = w.view(kp // 16, 2, 4, 2, np_ // 16, 2, 8)
    #   dims: kt, half, t, j, pair, tile, g -> kt, pair, g, t, tile, half, j
    return w.permute(0, 4, 6, 2, 5, 1, 3).reshape(-1).contiguous()


def unpack_b(flat: torch.Tensor, k: int, n: int, interleave: bool = False) -> torch.Tensor:
    """Inverse of pack_b: the padded bf16 matrix [pad16(k), pad16(n)]."""
    kp, np_ = pad16(k), pad16(n)
    w = flat.view(kp // 16, np_ // 16, 8, 4, 2, 2, 2)
    w = w.permute(0, 5, 3, 6, 1, 4, 2).reshape(kp, np_)
    if interleave:
        out = torch.empty_like(w)
        out[:, _interleave_perm(n).to(w.device)] = w
        return out
    return w


def pad32(n: int) -> int:
    return -(-n // 32) * 32


def pack_b_s8(w: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] -> flat int8 [pad32(K) * pad16(N)] in the fragment order of
    `mma.m16n8k32.s8` (csrc/mma_s8.cuh): as pack_b, with a 32-row K tile of
    bytes, a lane's b0 = B[4t .. 4t+3, g] and b1 = B[16+4t .. 16+4t+3, g]."""
    k, n = w.shape
    kp, np_ = pad32(k), pad16(n)
    w = F.pad(w.to(torch.int8), (0, np_ - n, 0, kp - k))
    # k = 32*kt + 16*half + 4*t + j ; n = 16*pair + 8*tile + g
    w = w.view(kp // 32, 2, 4, 4, np_ // 16, 2, 8)
    #   dims: kt, half, t, j, pair, tile, g -> kt, pair, g, t, tile, half, j
    return w.permute(0, 4, 6, 2, 5, 1, 3).reshape(-1).contiguous()


def unpack_b_s8(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of pack_b_s8: the padded int8 matrix [pad32(k), pad16(n)]."""
    kp, np_ = pad32(k), pad16(n)
    w = flat.view(kp // 32, np_ // 16, 8, 4, 2, 2, 4)
    return w.permute(0, 5, 3, 6, 1, 4, 2).reshape(kp, np_)
