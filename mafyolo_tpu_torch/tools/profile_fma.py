"""FMA-rate probe on the card: 25 dependent FMAs per element, f32 accumulation
over a bf16 operand (the inner loop of a 5x5 depthwise stencil), as a
hand-written kernel (csrc/fma_probe.cu) beside two plain PyTorch chains.

Counterpart of tools/profile_vpu.py: `fma_plain` and `fma_plain_bf16` are
its `xla_fma` and `xla_fma_bf16` (:34-48), `fma_chain` its `pallas_fma`.

    python -m mafyolo_tpu_torch.tools.profile_fma

times the three at the TPU tool's shape, x [32768, 1536] bf16, and prints
ms, TFLOP/s and GB/s for each. It needs a CUDA card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.utils.timing import cuda_ms

TAPS = 25
SHAPE = (32768, 1536)
_SIG = {"fma_probe": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}


def fma_plain(x, w):
    """25 dependent FMAs, f32 accumulator over a bf16 operand -> bf16."""
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(TAPS):
        acc = acc + x.float() * w[i]
    return acc.to(torch.bfloat16)


def fma_plain_bf16(x, w):
    """The same chain with a bf16 accumulator."""
    acc = torch.zeros(x.shape, dtype=torch.bfloat16, device=x.device)
    for i in range(TAPS):
        acc = acc + x * w[i].to(torch.bfloat16)
    return acc


def fma_chain(x, w):
    """bf16 x (any shape), f32 w [25] -> bf16 of the f32-accumulated chain:
    the plain version on a CPU tensor, the kernel on a CUDA tensor."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.float32 or tuple(w.shape) != (TAPS,):
        raise ValueError(f"fma_chain: want bf16 x and f32 w [{TAPS}], got "
                         f"{x.dtype} and {w.dtype} {tuple(w.shape)}")
    if x.device.type == "cpu":
        return fma_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise RuntimeError(f"fma_chain: x on {x.device}, w on {w.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("fma_chain: x must start on a 16-byte boundary (16-byte loads)")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    lib = _build.load("fma_probe", _SIG)
    err = lib.fma_probe(x.data_ptr(), w.contiguous().data_ptr(), y.data_ptr(), n,
                        -(-max(n // 8, 1) // 256),
                        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fma_probe kernel")
    fma_chain.launches += 1
    return y


fma_chain.launches = 0


def rates(ms: float, numel: int):
    """(TFLOP/s, GB/s) of one chain over `numel` bf16 elements in `ms`: 2
    FLOP per FMA, each element read and written once."""
    return 2 * TAPS * numel / ms / 1e9, 4 * numel / ms / 1e6


def measure(x, w, iters: int = 50):
    """[(name, ms, TFLOP/s, GB/s)] of the two plain chains and the kernel on
    x and w on the card."""
    out = []
    for name, fn, n in (("plain f32-acc chain", fma_plain, max(iters // 10, 1)),
                        ("plain bf16 chain", fma_plain_bf16, max(iters // 10, 1)),
                        ("kernel f32-acc", fma_chain, iters)):
        ms = cuda_ms(lambda: fn(x, w), n)
        out.append((name, ms, *rates(ms, x.numel())))
    return out


def operands(device, seed: int = 0):
    """x [32768, 1536] bf16 and w [25] f32 from a seed, as profile_vpu.py."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(SHAPE, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal(TAPS).astype(np.float32))
    return x.to(device, torch.bfloat16), w.to(device)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_fma: needs a CUDA card")
    x, w = operands(torch.device("cuda"))
    print(f"{torch.cuda.get_device_name(0)}; elements: {x.numel() / 1e6:.1f}M, "
          f"{2 * TAPS * x.numel() / 1e9:.2f} GFLOP for {TAPS} FMAs")
    for name, ms, tflops, gbs in measure(x, w):
        print(f"{name:20s}: {ms:8.3f} ms  ({tflops:6.2f} TFLOP/s, {gbs:7.1f} GB/s)")


if __name__ == "__main__":
    main()
