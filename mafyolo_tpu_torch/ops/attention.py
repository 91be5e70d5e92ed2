"""The attention of YOLO11's PSA blocks (models/blocks.py:Attention).

    out = softmax(q k^T * scale) v,   q, k [B, h, N, dk], v [B, h, N, dv]

with the softmax over the keys, dk 32 and dv 64 in YOLO11 (6 heads over
the 400 cells of a 20 x 20 map at 640 px). `psa_attention` runs it through
torch's fused scaled-dot-product attention. On the card in bf16 or fp16 it
takes the FlashAttention backend alone (its kernels are named
`flash_fwd_*`, which the benchmark's device trace reads), in f32 the
memory-efficient one (`fmha_cutlass*`); neither falls back to another.
Both want q, k and v of one head size, so q and k are padded with zeros to
dv: a zero channel adds nothing to a dot product, and the scale stays the
caller's (dk^-0.5), so the padded attention is the same function. On the
CPU it is torch's own implementation, unpadded.

`psa_attention.launches` counts the calls that produced an output, on any
device; a CUDA-graph replay counts as the calls it holds
(core/graphs.py:COUNTERS).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _backend(dtype):
    from torch.nn.attention import SDPBackend
    if dtype in (torch.bfloat16, torch.float16):
        return SDPBackend.FLASH_ATTENTION
    return SDPBackend.EFFICIENT_ATTENTION


def psa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for q, k [B, h, N, dk] and v [B, h, N, dv]
    (dk <= dv; each with a unit last stride on the card) -> [B, h, N, dv]."""
    dk, dv = q.shape[-1], v.shape[-1]
    if k.shape[-1] != dk or dk > dv:
        raise ValueError(f"psa_attention: want q and k of one head size at most v's, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cuda":
        from torch.nn.attention import sdpa_kernel
        if dk < dv:
            q, k = F.pad(q, (0, dv - dk)), F.pad(k, (0, dv - dk))
        with sdpa_kernel(_backend(q.dtype)):
            out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    else:
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    if out.numel():
        psa_attention.launches += 1
    return out


psa_attention.launches = 0
