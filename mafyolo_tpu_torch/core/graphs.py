"""Shape-keyed CUDA graphs of a predict: the port's counterpart of jax.jit's
one executable a path (mafyolo_tpu/core/evaler.py:115,
mafyolo_tpu/core/quant.py:334).

jax.jit traces a predict once for each input shape and value of its static
arguments and runs it as one executable, whose lax.cond takes the overflow
branch of the fused decode + NMS on the device (mafyolo_tpu/ops/nms.py:
280-284). Here a predict is given as its stages, stages(x, **static) ->
(detections, overflow, dense), as ops/nms.py:decode_nms_stages returns
them: the fast stage's detections dict, a 0-d device bool, and a function
of no arguments that runs the dense stage. The first call of a key (input
shape and dtype, and the static arguments: the thresholds and
multi_label) warms the stages up on a side stream and captures the fast
stage and the dense stage as two CUDA graphs. Each call copies its batch
into the key's static input, replays the fast graph, reads the flag (the
one host read of a predict, after its device work) and replays the dense
graph where the flag is set. It returns clones of the static outputs,
which the next replay overwrites.

Every graph of a PredictGraphs is captured on one memory pool, and every
warm-up runs in it. What a capture frees, the next capture may take, so a
replay may overwrite any tensor that another graph left in the pool but
did not keep alive, and the static outputs of the other keys too. That is
safe because a call is a whole on one stream: its fast replay, then its
dense replay (which reads the head maps that the fast graph leaves, kept
alive for it), then the clones, before any other replay. So the pool
holds the largest key's activations once and each key's live tensors (its
head maps and outputs), not a key's activations for each key. At most
MAX_KEYS keys are held; the least recently used goes first, and comes
back by a new capture. (A loop of rect shapes, sorted by aspect ratio,
meets each shape in one run of batches.) A graph holds the addresses of
the tensors it was captured on, weights included: whoever replaces the
weights makes a new PredictGraphs.

The kernels' launch counters advance in Python, so at capture only. Each
graph's counts are read at capture and added again at each replay, the
dense graph's only when it replays; after any number of calls the counters
read as after the same eager calls. A capture that fails raises: nothing
runs eager in a graph's place.

Spans (utils/trace.py). A call is the root span `predict`, with the
children `copy_in`, `replay_fast`, `replay_dense` (where the flag is set)
and `clone_out`; these record while a torch profiler records. A new key's
`capture`, with `capture.warmup` and `capture.graphs` under it, records
always; `warmup_ms` and `capture_ms` are those two spans' durations. On
the card, `copy_in`, `replay_fast`, `replay_dense` and `clone_out` mark
their device start and end, so that a call lies on the device's clock as
consecutive intervals: the copy, from its end to the fast replay's launch
(the host's return from the copy), the fast graph with its launch, from
its end to the next device op (the host's flag read), the dense graph, the
clones, and from the last clone to the next call's copy (the caller's own
time). The graphs hold no mark of their own, so the fast graph's interval
holds its launch's latency: an event-record node at the graph's head would
cost every replay a node, and under the profiler it runs ahead of the
kernels, whose launch the profiler delays (some 1 ms for the int8 graph on
an H100).
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from mafyolo_tpu_torch.ops import attention, dw_deploy, frontend, greedy_nms, quant_conv
from mafyolo_tpu_torch.utils import trace

# (function, attribute) of every launch counter on the serving paths
COUNTERS = ((frontend.frontend_forward, "launches"), (greedy_nms.greedy_nms, "launches"),
            (quant_conv.int8_conv, "launches"), (quant_conv.int8_conv, "launches_3x3"),
            (quant_conv.int8_dw, "launches"), (dw_deploy.dw_conv, "launches"),
            (attention.psa_attention, "launches"))
MAX_KEYS = 8       # keys a PredictGraphs holds at once


def _counts():
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _set_counts(values):
    for (fn, attr), v in zip(COUNTERS, values):
        setattr(fn, attr, v)


def _add_counts(deltas):
    _set_counts([v + d for v, d in zip(_counts(), deltas)])


def _capture(fn, pool, stream):
    """(graph, fn's outputs) of fn() captured into a CUDA graph on
    `stream`, its memory from `pool` (a torch.cuda.MemPool)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool.id, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out


class _KeyGraphs:
    """The fast and dense graphs of one key, their static input and outputs,
    their launch counts, and what capturing them cost: warm-up and capture
    ms (the `capture.*` spans' durations), and the bytes the pool grew by.
    The warm-up runs where the captures do, on the side stream and in the
    pool, so that they take the memory it leaves free (the allocator reuses
    a block on its own stream only)."""

    def __init__(self, stages, shape, dtype, static, device, side, pool):
        self.x = torch.empty(shape, dtype=dtype, device=device)     # any bytes will do
        self.card = device if device.type == "cuda" else None      # where spans mark
        start = _counts()
        try:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            with trace.span("capture.warmup") as warm:
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side), torch.cuda.use_mem_pool(pool):
                    stages(self.x, **static)[2]()
                torch.cuda.current_stream(device).wait_stream(side)
                _set_counts(start)
            with trace.span("capture.graphs") as graphs:
                self.fast, (self.dets, self.overflow, self.dense_stage) = _capture(
                    lambda: stages(self.x, **static), pool, side)
                mid = _counts()
                # the dense stage reads the head maps that the fast graph leaves
                # in the pool; dense_stage keeps them
                self.dense, self.dense_dets = _capture(self.dense_stage, pool, side)
                end = _counts()
        finally:
            _set_counts(start)
        self.fast_counts = [b - a for a, b in zip(start, mid)]
        self.dense_counts = [b - a for a, b in zip(mid, end)]
        self.warmup_ms, self.capture_ms = warm.seconds * 1e3, graphs.seconds * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def run(self, imgs_u8):
        """One call: the spans copy_in, replay_fast, replay_dense (where the
        flag is set) and clone_out, with device marks on the card (while a
        profiler records). A host batch's copy is issued without waiting and
        then waited for, as a blocking copy is, so that its end is marked on
        the device and not where the host came back."""
        dev = self.card
        with trace.hot("copy_in", dev) as s:
            s.start()
            self.x.copy_(imgs_u8, non_blocking=True)
            s.end()
            if dev is not None and imgs_u8.device.type == "cpu":
                torch.cuda.current_stream(dev).synchronize()
        with trace.hot("replay_fast", dev) as s:
            s.start()
            self.fast.replay()
            s.end()
        _add_counts(self.fast_counts)
        out = self.dets
        self.overflowed = bool(self.overflow.item())     # as read at this call
        if self.overflowed:
            with trace.hot("replay_dense", dev) as s:
                s.start()
                self.dense.replay()
                s.end()
            _add_counts(self.dense_counts)
            out = self.dense_dets
        with trace.hot("clone_out", dev) as s:
            s.start()
            out = {k: v.clone() for k, v in out.items()}
            s.end()
        return out


class PredictGraphs:
    """A predict on `device` (a CUDA device) through one pair of CUDA graphs
    per key; see the module docstring. stages(x, **static) is called with
    x the key's static uint8 input on the device. `captures` counts the
    keys captured so far, dropped ones included, and `capture_ms` sums
    their warm-up and capture ms."""

    def __init__(self, stages, device):
        self.stages = stages
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"PredictGraphs: CUDA graphs need a CUDA device, not {self.device}")
        self.side = torch.cuda.Stream(self.device)      # the warm-ups' stream
        self.pool = torch.cuda.MemPool()                # every graph's memory
        self.keys = OrderedDict()                       # least recently used first
        self.captures, self.capture_ms = 0, 0.0

    def __call__(self, imgs_u8, **static):
        """uint8 images (a tensor on the host or the device, or a numpy
        array) -> the detections dict of stages(imgs_u8, **static), read
        after the device work; a host batch is copied straight into the
        static input."""
        with trace.hot("predict"):
            imgs = torch.as_tensor(imgs_u8)
            key = (tuple(imgs.shape), imgs.dtype, *sorted(static.items()))
            graphs = self.keys.get(key)
            if graphs is None:
                while len(self.keys) >= MAX_KEYS:
                    self.keys.popitem(last=False)
                with trace.span("capture"), torch.no_grad():
                    graphs = self.keys[key] = _KeyGraphs(self.stages, imgs.shape, imgs.dtype,
                                                         static, self.device, self.side,
                                                         self.pool)
                self.captures += 1
                self.capture_ms += graphs.warmup_ms + graphs.capture_ms
            self.keys.move_to_end(key)
            return graphs.run(imgs)
