"""Timings behind the design of the front-end and neck kernels, on the card.

    python -m mafyolo_tpu_torch.tools.tune_kernels frontend
    python -m mafyolo_tpu_torch.tools.tune_kernels neck

`frontend`: the bf16 front-end kernel at bs32@640 for MAF-YOLO-N, -S and -M
over a list of (tile rows, tile columns, threads), each checked against the
plain version first and with the share of block clocks each phase takes,
beside the plan the kernel picks itself.
`neck`: the neck kernel's device time split by launch (kernel name, in
launch order) for N and S at h = 80, bs32, in bf16 and f32, read from
torch.profiler. Weights and inputs are random, from a seed. Each prints one
JSON object a line and needs a CUDA card.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.models.graph import parse_graph
from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.ops import frontend as FE
from mafyolo_tpu_torch.ops import neck as NK
from mafyolo_tpu_torch.utils.bridge import random_folded_variables
from mafyolo_tpu_torch.utils.timing import cuda_ms

BATCH, IMG = 32, 640
PHASES = ("input", "l0", "l1", "cv_in", "expand", "dw", "project", "cv_out")
TILES = [(16, 16, 512), (8, 16, 512), (8, 16, 256), (8, 8, 512), (8, 8, 256), (4, 8, 256)]


def _model(name, dev):
    specs = parse_graph(MODEL_ZOO[name], nc=80)[0]
    ev = Evaler(half=False, device=dev)
    ev.init_model(name, random_folded_variables(specs, seed=1), nc=80, folded=True)
    return ev


def frontend(dev):
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)).to(dev)
    lib = _build.load("frontend", FE._SIG)
    for name in ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m"):
        fw = _model(name, dev).fe_weights
        want = FE.frontend_plain(x[:2], fw)
        out = torch.empty((BATCH, IMG // 4, IMG // 4, fw.cfg.c2), dtype=torch.bfloat16,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        print(json.dumps({"model": name, "picked": FE.frontend_plan(fw), "picked_ms": cuda_ms(
            lambda: FE.frontend_forward(x, fw, torch.bfloat16), 10)}), flush=True)
        for th, tw, threads in TILES:
            def run(imgs=x, prof=0):
                return lib.frontend_bf16_tile(
                    imgs.data_ptr(), fw.flat.data_ptr(), fw.mma.data_ptr(), out.data_ptr(),
                    imgs.shape[0], IMG, IMG, *fw.cfg.dims(), th, tw, threads, prof, stream)
            err = run(x[:2].contiguous())
            torch.cuda.synchronize()
            if err:
                print(json.dumps({"model": name, "tile": [th, tw], "threads": threads,
                                  "error": lib.error_string(err).decode()}), flush=True)
                continue
            diff = (out[:2].float() - want).abs()
            ms = cuda_ms(run, 10)
            clocks = torch.zeros(8, dtype=torch.int64, device=dev)
            run(prof=clocks.data_ptr())
            torch.cuda.synchronize()
            share = (clocks.double() / clocks.sum()).tolist()
            print(json.dumps({"model": name, "tile": [th, tw], "threads": threads,
                              "ms": ms, "max_abs_err": diff.max().item(),
                              "mean_abs_err": diff.mean().item(),
                              "phase_share": dict(zip(PHASES, share))}), flush=True)


def neck(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in ("maf-yolo-n", "maf-yolo-s"):
        model = _model(name, dev).model
        cfg = NK.neck80_cfg(model.specs, IMG // 8)
        nw = NK.neck80_build(model.net, cfg)
        xs32 = [torch.randn((BATCH, cfg.h, cfg.h, c), generator=gen, device=dev) * 0.5
                for c in cfg.cins]
        for dtype in (torch.bfloat16, torch.float32):
            xs = [x.to(dtype) for x in xs32]
            total = cuda_ms(lambda: NK.neck80_forward(*xs, nw, dtype), 5)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                NK.neck80_forward(*xs, nw, dtype)
                torch.cuda.synchronize()
            spans = sorted((e.time_range.start, e.time_range.end - e.time_range.start, e.name)
                           for e in prof.events() if e.device_type == DeviceType.CUDA)
            print(json.dumps({"model": name, "dtype": str(dtype), "ms": total,
                              "launches": [[n.replace("(anonymous namespace)::", "").split("(")[0][-40:],
                                             us / 1e3]
                                           for _, us, n in spans]}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("frontend", "neck"):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("tune_kernels: no CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    {"frontend": frontend, "neck": neck}[sys.argv[1]](torch.device("cuda:0"))
