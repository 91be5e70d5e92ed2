"""Timings behind the design of the hand-written kernels, on the card.

    python -m mafyolo_tpu_torch.tools.tune_kernels frontend
    python -m mafyolo_tpu_torch.tools.tune_kernels neck
    python -m mafyolo_tpu_torch.tools.tune_kernels dw_grad [all]
    python -m mafyolo_tpu_torch.tools.tune_kernels nms
    python -m mafyolo_tpu_torch.tools.tune_kernels stem

`frontend`: the bf16 front-end kernel at bs32@640 for MAF-YOLO-N, -S and -M
over a list of (tile rows, tile columns, threads), each checked against the
plain version first and with the share of block clocks each phase takes,
beside the plan the kernel picks itself.
`neck`: the neck kernel's device time split by launch (kernel name, in
launch order) for N and S at h = 80, bs32, in bf16 and f32, read from
torch.profiler.
`dw_grad`: the depthwise weight-gradient kernel at every distinct depthwise
site of MAF-YOLO-N's train graph at bs32@640 in bf16: the cut the planner
picks and its ms (by CUDA events around eager calls, and from a CUDA graph of
20 calls, which leaves the host out; the calls take copies of the inputs in
turn, enough of them that none is found in the L2 cache, as in a train step;
`device_warm_ms` is the graph on one set of inputs), a sweep of other cuts
(each checked against the plain version's value first, timed from a graph;
the table ops/dw_grad.py:TILE was read from it), the share of block clocks
each phase of the tile kernel takes, the second launch (the sum of the
splits) alone, aten's convolution_backward (weight gradient only) both ways
and the bound, then the sums per class of site (H, k) over all sites of a
train step.
`nms`: the greedy-NMS kernel at B = 32 and M = 256, 512 and 2000 on random
boxes: the whole call, phase A (bit matrix) and phase B (scan) alone, and
the plain version; then the same on the candidates of one bs32@640 predict of
MAF-YOLO-N (utils/sample.py:random_deploy's weights).
`stem`: the stem kernel at bs32@640 in bf16 for MAF-YOLO-N, -S and -M over
band heights (output rows a band) and blocks an SM, each checked against the
plain version first (within one bf16 rounding), timed by CUDA events on
copies of the input taken in turn (none in L2), with the share of thread 0's
clocks each phase takes (input wait, MMA, store, barriers); the last line
sums each (rows, blocks an SM) over the three models, fastest first, beside
the pair the wrapper uses (ops/stem.py:ROWS, BLOCKS_PER_SM).
Weights and inputs are random, from a seed. Each prints one JSON object a
line and needs a CUDA card.
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
from mafyolo_tpu_torch.ops import dw_grad as DG
from mafyolo_tpu_torch.ops import frontend as FE
from mafyolo_tpu_torch.ops import neck as NK
from mafyolo_tpu_torch.ops import stem as ST
from mafyolo_tpu_torch.utils import sample
from mafyolo_tpu_torch.utils.bridge import random_folded_variables
from mafyolo_tpu_torch.utils.timing import cuda_ms, graph_ms

BATCH, IMG = 32, 640
PHASES = ("input", "l0", "l1", "cv_in", "expand", "dw", "project", "cv_out")
TILES = [(16, 16, 512), (8, 16, 512), (8, 16, 256), (8, 8, 512), (8, 8, 256), (4, 8, 256)]
STEM_ROWS, STEM_PER_SM = (1, 2, 3, 4, 6), (1, 2, 3, 4)
STEM_PHASES = ("input", "mma", "store", "barriers")


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


def dw_cuts(c, ho, wo, k, dil, sms):
    """Every cut the sweep tries: whole images, halves, quarters and bands of
    8, 4, 2 and 1 rows by strips of 10 to 80 columns, in each form the kernel
    is built for, where a tensor copy can bring the tile and it fits in a
    block's shared memory."""
    halo = (k - 1) * dil
    ths = sorted({ho, -(-ho // 2), -(-ho // 4), *(t for t in (8, 4, 2, 1) if t < ho)})
    tws = sorted({-(-wo // DG.RUN) * DG.RUN, *(t for t in (10, 20, 40, 80) if t < wo)})
    cuts = [DG.cut(BATCH, c, ho, wo, k, dil, 2, sms, th, tw, cpt)
            for cpt in DG.forms(k, dil) for th in ths for tw in tws
            if th + halo <= DG.BOX_LIMIT and tw + halo <= DG.BOX_LIMIT]
    return [p for p in cuts if p.smem <= DG.SMEM_LIMIT]


def dw_grad(dev, full=False):
    from mafyolo_tpu_torch.models import build_model
    torch.manual_seed(0)
    model = build_model("maf-yolo-n", nc=80).to(dev).to(memory_format=torch.channels_last)
    sites = sample.dw_sites(model, IMG, dev)
    del model
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_class, by_tile = {}, {}
    for site in sorted(set(sites)):
        c, h, w, k, pad, dil = site
        count = sites.count(site)
        x, g = sample.dw_site_inputs(site, BATCH, dev)
        sets = sample.cold_sets((x, g))
        want = DG.dw_grad_plain(x, g, k, pad, dil)
        tol = 1e-3 * want.abs().max().item()
        picked = DG.plan(BATCH, c, g.shape[2], g.shape[3], k, pad, dil, 2, sms)

        def kernel(x, g, p=None):
            return DG.dw_grad_cut(x, g, k, pad, dil, p) if p else DG.dw_grad(x, g, k, pad, dil)
        library = sample.dw_library(x, k, pad, dil)
        ms = cuda_ms(sample.in_turn(kernel, sets), 20)
        device_ms = graph_ms(sample.in_turn(kernel, sets))
        warm_ms = graph_ms(lambda: kernel(x, g))
        lib_ms = cuda_ms(sample.in_turn(library, sets), 20)
        lib_device_ms = graph_ms(sample.in_turn(library, sets))
        bound_ms = (2 * x.numel() * 2 + c * k * k * 4) / 3.35e12 * 1e3
        # the second launch (the fixed-order sum of the splits) alone
        part = torch.zeros(picked.n_split * k * k * c, device=dev)
        out = torch.empty(c * k * k, device=dev)
        lib = _build.load("dw_grad", DG._SIG)
        reduce_ms = graph_ms(lambda: lib.dw_grad_reduce(
            part.data_ptr(), out.data_ptr(), picked.n_split, k * k, c,
            _build.current_stream(dev)))
        sweep, shares = [], None
        if not picked.streaming:
            clocks = torch.zeros(len(DG.PHASES), dtype=torch.int64, device=dev)
            DG.dw_grad_cut(x, g, k, pad, dil, picked, prof=clocks)
            torch.cuda.synchronize()
            blocks = -(-c // (32 * picked.cpt)) * picked.n_split
            shares = {"clocks_per_block": clocks.sum().item() / blocks,
                      **dict(zip(DG.PHASES, (clocks.double() / clocks.sum()).tolist()))}
            for p in dw_cuts(c, g.shape[2], g.shape[3], k, dil, sms):
                err = (kernel(x, g, p) - want).abs().max().item()
                sweep.append({"th": p.th, "tw": p.tw, "cpt": p.cpt, "n_split": p.n_split,
                              "smem": p.smem, "ok": err <= tol,
                              "ms": graph_ms(sample.in_turn(
                                  lambda x, g, p=p: kernel(x, g, p), sets), 10)})
            sweep.sort(key=lambda r: r["ms"])
            # one tile for all sites of a kernel size: its summed ms, where
            # the sweep holds its clipped form at every site
            swept = {(r["th"], r["tw"], r["cpt"]): r["ms"] for r in sweep}
            for th in (4, 8, 10, 20):
                for tw in (10, 20, 40):
                    for cpt in DG.forms(k, dil):
                        here = swept.get((min(th, g.shape[2]),
                                          min(tw, -(-g.shape[3] // DG.RUN) * DG.RUN), cpt))
                        tot = by_tile.setdefault(k, {}).setdefault(f"{th}x{tw}x{cpt}", 0.0)
                        by_tile[k][f"{th}x{tw}x{cpt}"] = (
                            None if here is None or tot is None else tot + count * here)
        print(json.dumps({"site": {"c": c, "h": h, "k": k, "count": count},
                          "picked": picked._asdict(), "input_sets": len(sets), "ms": ms,
                          "library_ms": lib_ms, "device_ms": device_ms,
                          "device_warm_ms": warm_ms, "library_device_ms": lib_device_ms,
                          "bound_ms": bound_ms, "reduce_device_ms": reduce_ms,
                          "phase_share": shares,
                          "sweep": sweep if full else sweep[:4],
                          "sweep_worst_ms": sweep[-1]["ms"] if sweep else None,
                          "sweep_all_ok": all(r["ok"] for r in sweep)}), flush=True)
        rec = {"sites": 1, "ms": ms, "library_ms": lib_ms, "device_ms": device_ms,
               "device_warm_ms": warm_ms, "library_device_ms": lib_device_ms,
               "bound_ms": bound_ms, "reduce_device_ms": reduce_ms,
               "best_cut_device_ms": min(device_ms, sweep[0]["ms"]) if sweep else device_ms}
        cls = per_class.setdefault(f"h{h}k{k}", dict.fromkeys(rec, 0))
        for key, v in rec.items():
            cls[key] += count * v
    total = {key: sum(v[key] for v in per_class.values()) for key in rec}
    print(json.dumps({"per_class": per_class, "per_step": total}), flush=True)
    print(json.dumps({"one_tile_per_k_device_ms": {
        k: dict(sorted(((t, v) for t, v in tiles.items() if v is not None),
                       key=lambda tv: tv[1])[:5]) for k, tiles in by_tile.items()},
        "tile_table": {k: list(v) for k, v in DG.TILE.items()}}), flush=True)


def nms_split(boxes, valid, thr=0.65, iters=20):
    """The NMS kernel on boxes [B,M,4], valid [B,M] on the card: the whole
    call and each phase alone, by CUDA events around eager calls (`*_ms`) and
    from a CUDA graph of `iters` calls (`*_device_ms`: no host in the way),
    the plain version, and the kept and valid counts."""
    from mafyolo_tpu_torch.ops import greedy_nms as G
    b, m = valid.shape
    lib = _build.load("greedy_nms", G._SIG)
    sup = torch.empty((b, G.matrix_words(m)), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, m), dtype=torch.bool, device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    want = G.greedy_nms_plain(boxes, valid, thr)
    if not torch.equal(G.greedy_nms(boxes, valid, thr), want):
        raise RuntimeError(f"greedy_nms kernel differs from plain at M={m}")
    return {
        "ms": cuda_ms(lambda: G.greedy_nms(boxes, valid, thr), iters),
        "device_ms": graph_ms(lambda: G.greedy_nms(boxes, valid, thr), iters),
        "phase_a_device_ms": graph_ms(lambda: lib.nms_bitmatrix(
            boxes.data_ptr(), sup.data_ptr(), b, m, thr,
            torch.cuda.current_stream(boxes.device).cuda_stream), iters),
        "phase_b_device_ms": graph_ms(lambda: lib.nms_scan(
            sup.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, m,
            torch.cuda.current_stream(boxes.device).cuda_stream), iters),
        "phase_a_ms": cuda_ms(lambda: lib.nms_bitmatrix(
            boxes.data_ptr(), sup.data_ptr(), b, m, thr, stream), iters),
        "phase_b_ms": cuda_ms(lambda: lib.nms_scan(
            sup.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, m, stream), iters),
        "plain_ms": cuda_ms(lambda: G.greedy_nms_plain(boxes, valid, thr), 3),
        "kept": int(want.sum().item()), "valid": int(valid.sum().item())}


def nms(dev):
    rng = np.random.default_rng(3)
    for m in (256, 512, 2000):
        boxes, valid = sample.random_boxes(rng, BATCH, m)
        rec = nms_split(torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))
        print(json.dumps({"inputs": "random", "batch": BATCH, "m": m, **rec}), flush=True)
    folded, _ = sample.random_deploy("maf-yolo-n", dev)
    ev = sample.evaler("maf-yolo-n", folded, True, dev)
    imgs = sample.images(100, BATCH).to(dev)
    for boxes, valid, thr in sample.capture_nms_inputs(lambda: ev.predict(imgs)):
        rec = nms_split(boxes, valid, thr)
        print(json.dumps({"inputs": "predict maf-yolo-n bs32@640", "batch": boxes.shape[0],
                          "m": boxes.shape[1], **rec}), flush=True)


def stem(dev):
    bf16 = torch.bfloat16
    x = sample.images(0, BATCH).to(dev)
    sets = sample.cold_sets((x,))
    totals = {}
    for name in ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m"):
        sw = ST.stem_build(_model(name, dev).model.net)
        want = ST.stem_plain(x[:2], sw)
        bound_ms = (x.numel() + BATCH * (IMG // 2) ** 2 * sw.cout * 2) / 3.35e12 * 1e3
        print(json.dumps({"model": name, "picked": [ST.ROWS, ST.BLOCKS_PER_SM],
                          "picked_ms": cuda_ms(sample.in_turn(
                              lambda x: ST.stem_conv_s2(x, sw, bf16), sets), 20),
                          "bound_ms": bound_ms}), flush=True)
        for rows in STEM_ROWS:
            for per_sm in STEM_PER_SM:
                def run(x, prof=None):
                    return ST._launch(x, sw, bf16, rows, per_sm, prof)
                ratio = ((run(x)[:2].float() - want).abs()
                         / (1e-6 + 2 ** -8 * want.abs())).max().item()
                ms = cuda_ms(sample.in_turn(run, sets), 20)
                clocks = torch.zeros(len(STEM_PHASES), dtype=torch.int64, device=dev)
                run(x, clocks)
                torch.cuda.synchronize()
                share = (clocks.double() / clocks.sum()).tolist()
                print(json.dumps({"model": name, "rows": rows, "blocks_per_sm": per_sm,
                                  "ms": ms, "bound_share": bound_ms / ms,
                                  "bf16_err_over_one_rounding": ratio, "ok": ratio <= 1,
                                  "phase_share": dict(zip(STEM_PHASES, share))}), flush=True)
                key = f"{rows}x{per_sm}"
                ok = ratio <= 1 and totals.get(key, 0.0) is not None
                totals[key] = totals.get(key, 0.0) + ms if ok else None
    ranked = sorted(((k, v) for k, v in totals.items() if v is not None), key=lambda kv: kv[1])
    print(json.dumps({"summed_ms_n_s_m": dict(ranked[:6]),
                      "best_rows_blocks_per_sm": ranked[0][0],
                      "wrapper": f"{ST.ROWS}x{ST.BLOCKS_PER_SM}"}), flush=True)


COMMANDS = {"frontend": frontend, "neck": neck, "dw_grad": dw_grad, "nms": nms, "stem": stem}

if __name__ == "__main__":
    args = sys.argv[1:]
    if args == ["dw_grad", "all"]:      # every cut of the sweep, not the best four
        args, COMMANDS["dw_grad"] = ["dw_grad"], lambda dev: dw_grad(dev, full=True)
    if len(args) != 1 or args[0] not in COMMANDS:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("tune_kernels: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False     # the plain versions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    COMMANDS[args[0]](torch.device("cuda:0"))
