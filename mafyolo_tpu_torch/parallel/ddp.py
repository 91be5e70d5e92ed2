"""Data parallel over processes (counterpart of mafyolo_tpu/parallel/mesh.py).

The JAX package trains on a 'data' mesh: one program over the global batch,
sharded, with the state replicated and the gradient all-reduce inserted by
XLA. Here each rank is a process with its own device. Inside a process group
of more than one rank the train step (core/train_state.py) computes what
that one program computes:
  * train-mode BatchNorm takes its statistics over the global batch
    (models/blocks.py:BatchNorm through all_reduce_sum; the flax rules:
    biased variance, momentum 0.97, eps 1e-3), so every rank's running
    statistics stay equal;
  * the loss is divided by the global target_scores_sum (all_reduce_sum);
  * an apply step sums the ranks' accumulated `.grad` (all_reduce_grads)
    before the optimizer: accumulate-only steps keep theirs local, since
    the sum is the same;
  * device augmentation draws for the global batch and each rank augments
    its own rows (device_augment_shard).
Row j of rank r's batch is row j * world + r of the global batch: the
loader's shard_id::num_shards stride (data/loader.py), so the ranks' batches
together are the one-process loader's batch. The model is not wrapped in
DistributedDataParallel: the gradients are summed by hand in one flat
all-reduce, and DDP's buffer broadcast has nothing to do when every rank
computes the same statistics.

Backends: NCCL on the card, gloo on the CPU; gloo on the card only when the
caller names it (two ranks on one card, where NCCL refuses). Gloo on CUDA
tensors offers all-reduce and broadcast only, so everything here but
gather_rows on NCCL is built from those two.
"""
from __future__ import annotations

import os
import socket
import sys
from typing import Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from mafyolo_tpu_torch.data import device_aug as DA


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_main_process() -> bool:
    return rank() == 0


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world: Optional[int] = None):
    """Join the process group -> (rank, world size, local rank). Without
    arguments it reads torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT); a caller that spawns its own ranks passes
    init_method, rank and world. backend defaults to NCCL for a CUDA
    device and gloo for the CPU; under NCCL the rank takes cuda:<local
    rank> as its current device before the rendezvous."""
    env = os.environ
    if rank is None:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = init_method or "env://"
    local_rank = int(env.get("LOCAL_RANK", rank))
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return rank, world, local_rank


def free_tcp_address() -> str:
    """tcp://localhost:<a port free now> for a group of ranks on this host."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _spawned(index, fn, world, init_method, backend, device, args):
    init_distributed(device, backend, init_method, index, world)
    try:
        fn(index, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, *args, device="cuda", backend: Optional[str] = None,
           init_method: Optional[str] = None):
    """Run fn(rank, *args) on `world` ranks, each in the process group: one
    rank runs in this process, more are spawned. init_method defaults to a
    free localhost port."""
    init_method = init_method or free_tcp_address()
    if world == 1:
        return _spawned(0, fn, 1, init_method, backend, device, args)
    # a spawned rank first runs the main module's file again: a program
    # read from standard input has none, the ranks die before they read
    # their arguments, and the spawn waits on them for ever
    main = getattr(sys.modules["__main__"], "__file__", None)
    if main is not None and not os.path.isfile(main):
        raise RuntimeError(f"spawned ranks re-run the main module, and {main!r} is not a "
                           "file: run the program from a file or with python -m")
    torch.multiprocessing.spawn(_spawned, args=(fn, world, init_method, backend, device, args),
                                nprocs=world, join=True)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the ranks' gradients summed."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks (a new tensor); autograd carries the sum
    of the ranks' gradients back through it. (torch.distributed.nn.functional
    .all_reduce computes the same, and is deprecated.)"""
    return _AllReduceSum.apply(t)


def all_reduce_grads(params: Iterable[torch.nn.Parameter]):
    """Sum every `.grad` over the ranks in place, in one flat all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()


def broadcast_state(module: torch.nn.Module):
    """Rank 0's parameters and buffers on every rank."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch of every rank's [b, ...] rows, interleaved (row
    j * world + r is rank r's row j): one all-gather on NCCL, one
    all-reduce of a zeroed buffer on gloo."""
    w, r, b, tail = world_size(), rank(), t.shape[0], tuple(t.shape[1:])
    if dist.get_backend() == "nccl":
        buf = torch.empty((w, b) + tail, dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(buf, t.contiguous())
        return buf.transpose(0, 1).reshape((b * w,) + tail)
    buf = torch.zeros((b, w) + tail, dtype=t.dtype, device=t.device)
    buf[:, r] = t
    dist.all_reduce(buf)
    return buf.reshape((b * w,) + tail)


def own_rows(b: int, device) -> torch.Tensor:
    """This rank's rows of a global batch of b * world rows."""
    w = world_size()
    return torch.arange(rank(), b * w, w, device=device)


def device_augment_shard(imgs_u8, labels, gen: torch.Generator, **cfg):
    """This rank's part of device_augment over the global batch: the draw is
    for the global batch (the same generator state on every rank), and the
    rank augments its own rows with their draws. The mosaic and mixup read
    other rows, so with the mosaic the rank gathers the global batch and
    warps only its rows and their mixup partners."""
    b, h, w, _ = imgs_u8.shape
    p = DA.draw(b * world_size(), h, w, gen, **cfg)
    rows = own_rows(b, imgs_u8.device)
    if "donors" in p:
        return DA.apply(gather_rows(imgs_u8), gather_rows(labels.float()), p, rows)
    return DA.apply(imgs_u8, labels, DA.take_rows(p, rows))


def check_devices(n: int, device) -> Sequence[torch.device]:
    """The first n devices of the kind of `device` (ranks on the CPU share
    it); more CUDA devices than the host has raises."""
    if torch.device(device).type != "cuda":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"--device-count {n}: this host has {have} CUDA device(s)")
    return [torch.device("cuda", i) for i in range(n)]
