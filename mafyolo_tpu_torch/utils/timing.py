"""Device time of a call on the CUDA card."""
from __future__ import annotations

import torch


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn on the card, by CUDA events around
    `iters` calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of fn with the host out of the way:
    `iters` calls captured into one CUDA graph, the graph replayed once to
    warm up and once between two events. fn must launch on the current
    stream and may allocate with torch."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
