"""Timings behind the design of the hand-written kernels, on the card.

    python -m mafyolo_tpu_torch.tools.tune_kernels frontend
    python -m mafyolo_tpu_torch.tools.tune_kernels neck
    python -m mafyolo_tpu_torch.tools.tune_kernels dw_grad [all]
    python -m mafyolo_tpu_torch.tools.tune_kernels nms
    python -m mafyolo_tpu_torch.tools.tune_kernels stem
    python -m mafyolo_tpu_torch.tools.tune_kernels int8
    python -m mafyolo_tpu_torch.tools.tune_kernels int8_caps
    python -m mafyolo_tpu_torch.tools.tune_kernels int8_3x3
    python -m mafyolo_tpu_torch.tools.tune_kernels dw [f32]

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
`int8`: the real-int8 conv kernels at every site of MAF-YOLO-N's int8
predict (random deploy weights, max-calibrated on 2 bs32@640 batches) at
bs32@640 in bf16, each checked against its plain version first: per site
the kernel's ms on the same input (warm) and on copies taken in turn, none
in L2 (cold), without its fused activation, the bound, torch._int_mm on the
site's quantized operands (dense; 3x3 s2 unfolded to [M, 9C], the unfold
not timed) and cuDNN's bf16 conv of the shape (another function), the share
of block clocks each phase takes (stage, MMA, epilogue, store; DW: stage,
compute, store); then sums per class of site and per kernel; then a cold
sweep of the tiles at each site with a tile choice (dense k > 1: the widths
ops/quant_conv.py:conv_tile weighs; DW: square sides and whole images: the
table ops/quant_conv.py:DW_TILE was read from it).
Then every 3x3 stride-1 site of office N's, M's and L's int8 predicts at
bs32@640 (the class csrc/int8_conv3x3.cuh takes): the same per site, the
phase shares window, B wait, MMA, epilogue, store; sums per graph.
`int8_caps`: each int8 kernel rebuilt with each of its compile-time knobs in
INT8_CAPS (registers a thread, B lookahead) and timed at every
site of its kind (N's and office N's 3x3 stride-1 sites), sums per class:
the kernels' defaults were read from it.
`dw`: the deploy depthwise kernel (csrc/dw_conv.cu) at every distinct
depthwise site of MAF-YOLO-N's, -S's and -M's bf16 predict at bs32@640
(random weights and inputs from a seed; `dw f32`: the same sites with f32
activations, weights and bias, as an f32 predict runs them, beside cuDNN's
f32 conv), each checked against the plain
version on the card first (within one bf16 rounding of its f32 result): per
site the kernel's ms on the same input (warm) and on copies taken in turn,
none in L2 (cold), both replayed from a CUDA graph (a site takes less
than the host needs to launch the op), its bytes, operations and bound,
and cuDNN's conv with its bias and the site's activation (what the
graph ran before the kernel; the port never calls it), cold; then sums per
model and class (k, side); then a cold sweep of tile sides at each
distinct site: its last line sums each side over the sites of a class,
which ops/dw_deploy.py:TILE was read from.
`int8_3x3`: the 3x3 stride-1 kernel at office N's, M's and L's sites: the
plan's cold ms and phase shares per distinct site, then a cold sweep of
output tiles x wgmma N x rings (int8_3x3's docstring); its last line is
what ops/quant_conv.py:TABLE3 and RING3 were read from.
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
from mafyolo_tpu_torch.ops import dw_deploy as DD
from mafyolo_tpu_torch.ops import dw_grad as DG
from mafyolo_tpu_torch.ops import frontend as FE
from mafyolo_tpu_torch.ops import neck as NK
from mafyolo_tpu_torch.ops import quant_conv as QC
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
        out = torch.empty((BATCH, IMG // 4, IMG // 4, fw.cfg.cout), dtype=torch.bfloat16,
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
    for boxes, valid, thr in sample.capture_nms_inputs(lambda: ev.predict_eager(imgs)):
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


# ---- int8: the real-int8 conv kernels at every site of N's int8 predict

def int8_inputs(model, x):
    """{module name: (pack, input, act)} of every QuantConv2d of an int8 model
    in one forward of x; act is the activation its launch fuses (None when
    the model applies it after the conv, and at a depthwise site, whose
    kernel fuses none). The hook returns None: a pre-hook that returns a
    value replaces the module's arguments."""
    from mafyolo_tpu_torch.models.blocks import QuantConv2d
    seen, hooks = {}, []

    def keep(name):
        def hook(mod, args, kwargs):
            act = None if mod.int8.kind == "dw" else kwargs.get("act")
            seen.setdefault(name, (mod.int8, args[0], act))
        return hook
    for name, m in model.named_modules():
        if isinstance(m, QuantConv2d):
            hooks.append(m.register_forward_pre_hook(keep(name), with_kwargs=True))
    model(x)
    for h in hooks:
        h.remove()
    return seen


def int8_site_bound(p, x, out):
    """(bytes, int8 operations) of one int8 conv launch: its input read
    once, its output written once, the int8 weights and the f32 scale and
    bias; 2 operations per multiply-add."""
    b, c, h, w = x.shape
    ho, wo = out.shape[2:]
    macs = b * ho * wo * p.cout * (c // p.groups) * p.k * p.k
    nbytes = (x.numel() + out.numel()) * x.element_size() + p.w_q.numel() + 8 * p.cout
    return nbytes, 2 * macs


def int8_site_class(p):
    return f"dw{p.k}" if p.kind == "dw" else f"{p.k}x{p.k}s{p.stride}"


def int_mm_operands(p, x):
    """torch._int_mm's operands for a dense site: the quantized input
    unfolded to [M, k*k*C] in (ky, kx, c) order, and the int8 weight
    [k*k*C, O]; K and O padded with zeros to multiples of 8, as _int_mm asks.
    The unfold is host-side preparation and is not part of a timed call."""
    F = torch.nn.functional
    xq = QC.quantize(x, p.x_scale_t).to(torch.int8).permute(0, 2, 3, 1)
    b, h, w, c = xq.shape
    k, s, pad = p.k, p.stride, p.pad
    ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
    if k > 1 or s > 1 or pad:
        xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
        xq = torch.cat([xp[:, ky:ky + s * (ho - 1) + 1:s, kx:kx + s * (wo - 1) + 1:s]
                        for ky in range(k) for kx in range(k)], -1)
    kk = k * k * c
    k8, o8 = -(-kk // 8) * 8, -(-p.cout // 8) * 8
    a = F.pad(xq.reshape(-1, kk), (0, k8 - kk)).contiguous()
    wm = p.w_q.permute(2, 3, 1, 0).reshape(kk, p.cout)
    return a, F.pad(wm, (0, o8 - p.cout, 0, k8 - kk)).contiguous()


INT8_PHASES = {"dense": ("stage", "mma", "epilogue", "store"),
               "dw": ("stage", "compute", "store"),
               "3x3s1": ("window", "b_wait", "mma", "epilogue", "store")}


def int8_phases(p, x, act=None, tile=None):
    """The share of thread 0's clocks each phase of one launch takes, summed
    over the blocks (tile: a conv_tile, a dw_tile or, at a 3x3 stride-1
    site, a Plan3)."""
    three = p.kind == "dense" and QC.is_3x3s1(p.k, p.stride, p.pad)
    names = INT8_PHASES["3x3s1" if three else p.kind]
    clocks = torch.zeros(len(names), dtype=torch.int64, device=x.device)
    fused = act if act in QC.FUSED_ACTS else None
    if three:
        QC.conv3x3_launch(x, p, fused, tile, clocks)
    elif p.kind == "dense":
        QC.conv_launch(x, p, fused, tile, clocks)
    else:
        QC.dw_launch(x, p, tile, clocks)
    torch.cuda.synchronize()
    return dict(zip(names, (clocks.double() / clocks.sum()).tolist()))


def time_int8_site(p, x, act=None, plain=True, phases=False):
    """One int8 conv site on the card: the kernel's ms on the same input
    (warm: a 20 px input stays in L2) and on copies of it taken in turn, enough
    that none is in L2 (cold), its bytes, operations and bound, the plain
    version's ms, and the yardsticks: torch._int_mm on the site's quantized
    operands (dense sites) and cuDNN's bf16 conv of the same shape (another
    function: no int8 conv exists in PyTorch on the card). equal_to_plain:
    the kernel's output (activation included) against the plain version's,
    bit for bit."""
    out = QC.int8_conv(x, p, act)
    nbytes, ops = int8_site_bound(p, x, out)
    equal = torch.equal(out, QC.ACTS[act](QC.int8_conv_plain(x, p)))
    sets = sample.cold_sets((x,))
    rec = {"shape": list(x.shape), "ldx": x.stride(3), "cout": p.cout, "k": p.k,
           "stride": p.stride, "act": act, "equal_to_plain": equal, "launches": 1,
           "ms": cuda_ms(lambda: QC.int8_conv(x, p, act), 5),
           "cold_ms": cuda_ms(sample.in_turn(lambda x: QC.int8_conv(x, p, act), sets),
                              max(10, len(sets))),
           "bytes": nbytes, "ops": ops,
           "bound_ms": max(nbytes / 3.35e12, ops / 1979e12) * 1e3}
    del sets
    if act is not None:     # the same launch without the fused activation
        rec["no_act_ms"] = cuda_ms(lambda: QC.int8_conv(x, p, None), 5)
    if phases:
        rec["phase_share"] = int8_phases(p, x, act)
    if plain:
        rec["plain_ms"] = cuda_ms(lambda: QC.int8_conv_plain(x, p), 2, warmup=1)
    if p.kind == "dense":
        a, bm = int_mm_operands(p, x)
        rec["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(a, bm), 5)
        del a, bm
    wb, bb, xb = p.w_q.to(torch.bfloat16), p.bias.to(torch.bfloat16), x.to(torch.bfloat16)
    rec["cudnn_bf16_ms"] = cuda_ms(lambda: torch.nn.functional.conv2d(
        xb, wb, bb, p.stride, p.pad, 1, p.groups), 5)
    return rec


def sum_int8_sites(recs):
    """Per class of site and per kernel ("dense", "dw"): the sums of every
    numeric field of the site records, the bound's limiter and the shares of
    the bound, warm and cold."""
    classes, kernels = {}, {}
    for r in recs:
        for agg in (classes.setdefault(r["class"], {}), kernels.setdefault(r["kind"], {})):
            for key, v in r.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool) and key not in (
                        "cout", "k", "stride", "ldx"):
                    agg[key] = agg.get(key, 0) + v
    for agg in list(classes.values()) + list(kernels.values()):
        t_b, t_f = agg["bytes"] / 3.35e12, agg["ops"] / 1979e12
        agg["bound_by"] = "bytes" if t_b >= t_f else "operations"
        agg["bound_over_ms"] = agg["bound_ms"] / agg["ms"]
        agg["bound_over_cold_ms"] = agg["bound_ms"] / agg["cold_ms"]
    return classes, kernels


def time_int8_model(model, x, plain=True, phases=False):
    """time_int8_site at every int8 conv site of one forward of x ->
    (site records, per class, per kernel)."""
    recs = []
    for name, (p, xi, act) in int8_inputs(model, x).items():
        recs.append({"site": name, "kind": p.kind, "class": int8_site_class(p),
                     **time_int8_site(p, xi, act, plain, phases)})
    return (recs, *sum_int8_sites(recs))


def int8_tiles(p, x):
    """The tiles the sweep tries at one site: DW, square sides and whole
    images; dense k > 1, every tile width conv_tile weighs."""
    b, c, h, w = x.shape
    if p.kind == "dw":
        return sorted({(min(t, h), min(t, w)) for t in (8, 12, 16, 20, 24, 32, 40)} | {(h, w)})
    ho, wo = (h + 2 * p.pad - p.k) // p.stride + 1, (w + 2 * p.pad - p.k) // p.stride + 1
    return [(QC.BM // tw, tw) for tw in sorted({64, 32, 16, 8, 4} | ({wo} if wo < QC.BM else
                                                                     set()))]


OFFICE_GRAPHS = ("yolov6n-office", "yolov6m-office", "yolov6l-office")


def office_3x3_inputs(name, dev):
    """{module name: (pack, input, act)} of the 3x3 stride-1 int8 sites of
    an office graph's int8 predict (random deploy weights, max-calibrated on
    2 bs32@640 batches) on one bs32@640 batch, bf16."""
    from mafyolo_tpu_torch.core import quant as Q
    from mafyolo_tpu_torch.models.office import office_config_graph
    graph = office_config_graph(name)
    folded = sample.random_deploy(graph, dev)[0]
    calib = [sample.images(300 + i, BATCH).to(dev) for i in range(2)]
    quant = Q.ptq_calibrate(graph, 80, folded, calib, max_batches=2, device=dev)
    p8 = Q.int8_predict_fn(graph, 80, folded, quant, device=dev)
    x = Q.normalize(sample.images(400, BATCH).to(dev), torch.bfloat16, dev)
    return {n: v for n, v in int8_inputs(p8.model, x).items()
            if int8_site_class(v[0]) == "3x3s1"}


def office_3x3(dev):
    """time_int8_site (with phase shares) at every 3x3 stride-1 site of
    office N, M and L's int8 predicts at bs32@640: one line a site, then the
    sums of the class per graph."""
    for name in OFFICE_GRAPHS:
        recs = [{"model": name, "site": n, "kind": p.kind, "class": int8_site_class(p),
                 **time_int8_site(p, xi, act, plain=False, phases=True)}
                for n, (p, xi, act) in office_3x3_inputs(name, dev).items()]
        for r in recs:
            print(json.dumps(r), flush=True)
        print(json.dumps({"model": name, "classes": sum_int8_sites(recs)[0]}), flush=True)


def int8(dev):
    from mafyolo_tpu_torch.core import quant as Q
    name = "maf-yolo-n"
    folded = sample.random_deploy(name, dev)[0]
    calib = [sample.images(300 + i, BATCH).to(dev) for i in range(2)]
    quant = Q.ptq_calibrate(name, 80, folded, calib, max_batches=2, device=dev)
    p8 = Q.int8_predict_fn(name, 80, folded, quant, device=dev)
    x = Q.normalize(sample.images(400, BATCH).to(dev), torch.bfloat16, dev)
    recs, classes, kernels = time_int8_model(p8.model, x, plain=False, phases=True)
    for r in recs:
        print(json.dumps(r), flush=True)
    for key, agg in classes.items():
        print(json.dumps({"class": key, **agg}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    # the tile sweep: each distinct site with a tile choice, on cold inputs
    done, summed = set(), {}
    for name, (p, xi, act) in int8_inputs(p8.model, x).items():
        key = (p.kind, p.k, p.stride, tuple(xi.shape[1:]), p.cout)
        if key in done or (p.kind == "dense" and p.k == 1):
            continue
        done.add(key)
        sets = sample.cold_sets((xi,))
        picked = (QC.dw_tile(p.k, *xi.shape[2:], p.cin, 2) if p.kind == "dw" else
                  QC.conv_tile(p.k, p.stride, p.pad, *_out_hw(p, xi), QC.pad16(p.cin), 2))
        want = QC.ACTS[act](QC.int8_conv_plain(xi, p))
        for tile in int8_tiles(p, xi):
            try:
                if p.kind == "dw":
                    def run(xx, tile=tile):
                        return QC.dw_launch(xx, p, tile)
                else:
                    def run(xx, tile=tile):
                        return QC.conv_launch(xx, p, act, tile)
                ok = torch.equal(QC.ACTS[None](run(xi)), want)
            except (RuntimeError, ValueError) as err:
                print(json.dumps({"site": name, "tile": tile, "error": str(err)}), flush=True)
                continue
            ms = cuda_ms(sample.in_turn(run, sets), max(10, len(sets)))
            print(json.dumps({"site": name, "tile": list(tile), "picked": tile == picked,
                              "equal_to_plain": ok, "cold_ms": ms}), flush=True)
            cls = int8_site_class(p)
            summed.setdefault(cls, {}).setdefault(str(list(tile)) if p.kind == "dense" else
                                                  tile[0] if tile != tuple(xi.shape[2:])
                                                  else "whole", []).append(ms)
        del sets
    print(json.dumps({"sweep_cold_ms_by_class": {
        c: {t: [sum(v), len(v)] for t, v in d.items()} for c, d in summed.items()}}), flush=True)
    office_3x3(dev)


# The 3x3 stride-1 sweep: output tiles (rows, columns, split_n), and rings
# (slots, 16-byte K chunks a slot) tried with the best tile of each class.
SWEEP3_TILES = ((8, 8, True), (16, 8, False), (8, 16, True), (16, 16, False), (32, 8, False),
                (8, 32, False))
SWEEP3_RINGS = ((2, 8), (3, 8), (4, 8), (6, 8), (4, 4), (6, 4), (8, 4))


def int8_3x3(dev):
    """The 3x3 stride-1 kernel at office N's, M's and L's sites (bs32@640,
    bf16): per distinct site (C, O, side, activation; `n` the sites a
    predict has of it) the plan3x3 plan's cold ms and phase shares, then a
    cold sweep of SWEEP3_TILES (wgmma N by the plan's rule; also the other
    N widths with the plan's tile) and of SWEEP3_RINGS with the site's best
    tile, each checked bit-equal to the plain version first. The last line
    sums each tile over the sites of a side class (20, 40, 80 px; counted
    n times): TABLE3 lists them fastest first; each ring summed over every
    site: RING3 starts with the fastest; and per graph the plans' cold ms
    and each site's fastest of the sweep, summed over a predict's sites."""
    by_tile, by_ring, planned, fastest = {}, {}, {}, {}
    sms = _build.sm_count(dev.index)
    for name in OFFICE_GRAPHS:
        seen = office_3x3_inputs(name, dev)
        distinct = {}
        for n, (p, xi, act) in seen.items():
            key = (p.cin, p.cout, xi.shape[2], act)
            distinct.setdefault(key, [n, p, xi, act, 0])[4] += 1
        for (c, o, side, act), (n, p, xi, _, count) in distinct.items():
            want = QC.ACTS[act](QC.int8_conv_plain(xi, p))
            sets = sample.cold_sets((xi,))
            cls = 20 if side <= 24 else 40 if side <= 48 else 80
            fused = act if act in QC.FUSED_ACTS else None

            def cold(plan):
                def run(xx):
                    return QC.conv3x3_launch(xx, p, fused, plan)
                ok = torch.equal(QC.ACTS[None if fused else act](run(xi)), want)
                return ok, cuda_ms(sample.in_turn(run, sets), max(10, len(sets)))

            def cut(th, tw, split_n, bnw=None, ring=None):
                return QC.cut3x3(side, side, c, o, 2, BATCH, sms, th, tw, split_n, bnw, ring)
            picked = QC.plan3x3(side, side, c, o, 2, BATCH, sms)
            ok, ms = cold(picked)
            planned[name] = planned.get(name, 0.0) + count * ms
            site_best = ms
            print(json.dumps({"model": name, "site": n, "c": c, "o": o, "side": side, "act": act,
                              "n": count, "plan": picked._asdict(), "equal_to_plain": ok,
                              "cold_ms": ms, "phase_share": int8_phases(p, xi, act, picked)}),
                  flush=True)
            best = None
            for th, tw, split_n in SWEEP3_TILES:
                base = cut(th, tw, split_n)
                if base is None:
                    continue
                widths = set(QC.BNW3) if (th, tw, split_n) == (
                    picked.th, picked.tw, picked.split_n) else {base.bnw}
                for bnw in sorted(widths):
                    plan = base if bnw == base.bnw else cut(th, tw, split_n, bnw)
                    if plan is None:
                        continue
                    ok, ms = cold(plan)
                    print(json.dumps({"model": name, "c": c, "o": o, "side": side,
                                      "plan": plan._asdict(), "equal_to_plain": ok,
                                      "cold_ms": ms}), flush=True)
                    site_best = min(site_best, ms)
                    if plan is base:
                        key = str([th, tw, split_n])
                        by_tile.setdefault(cls, {}).setdefault(key, 0.0)
                        by_tile[cls][key] += count * ms
                        if best is None or ms < best[0]:
                            best = (ms, (th, tw, split_n))
            for ring in SWEEP3_RINGS:
                plan = cut(*best[1], ring=ring)
                if plan is None:
                    continue
                ok, ms = cold(plan)
                print(json.dumps({"model": name, "c": c, "o": o, "side": side,
                                  "plan": plan._asdict(), "equal_to_plain": ok,
                                  "cold_ms": ms}), flush=True)
                by_ring[str(list(ring))] = by_ring.get(str(list(ring)), 0.0) + count * ms
                site_best = min(site_best, ms)
            fastest[name] = fastest.get(name, 0.0) + count * site_best
            del sets
        del seen
        torch.cuda.empty_cache()
    print(json.dumps({"tiles_by_side": {c: sorted(((v, k) for k, v in d.items()))
                                        for c, d in by_tile.items()},
                      "rings": sorted((v, k) for k, v in by_ring.items()),
                      "planned_ms": planned, "fastest_ms": fastest}), flush=True)


# The compile-time knobs of the int8 kernels the caps sweep rebuilds them
# with: the dense kernel's (blocks an SM the register budget is cut for, K
# steps of B lookahead), the depthwise kernel's blocks an SM at k 3 and 5.
# The first of each is the kernel's default.
INT8_CAPS = {"int8_conv": [(8, 1), (4, 2), (6, 2), (6, 1)], "int8_dw": [(3,), (1,), (2,)]}
_CAP_MACROS = {"int8_conv": ("INT8_CONV_MIN_BLOCKS", "INT8_CONV_AHEAD"),
               "int8_dw": ("INT8_DW_MIN_BLOCKS",)}


def int8_caps(dev):
    """Each int8 kernel rebuilt with each of its INT8_CAPS and timed at every
    site of its kind (warm and cold, summed per class), checked against the
    plain version first; ptxas's registers and spills beside."""
    from mafyolo_tpu_torch.core import quant as Q
    name = "maf-yolo-n"
    folded = sample.random_deploy(name, dev)[0]
    calib = [sample.images(300 + i, BATCH).to(dev) for i in range(2)]
    quant = Q.ptq_calibrate(name, 80, folded, calib, max_batches=2, device=dev)
    p8 = Q.int8_predict_fn(name, 80, folded, quant, device=dev)
    seen = int8_inputs(p8.model, Q.normalize(sample.images(400, BATCH).to(dev),
                                             torch.bfloat16, dev))
    seen.update({f"yolov6n-office.{n}": v
                 for n, v in office_3x3_inputs("yolov6n-office", dev).items()})
    default = dict(_build.EXTRA_FLAGS)
    for lib, caps in INT8_CAPS.items():
        kind = "dense" if lib == "int8_conv" else "dw"
        for cap in caps:
            _build.EXTRA_FLAGS[lib] = [f"-D{m}={v}" for m, v in zip(_CAP_MACROS[lib], cap)]
            _build._LOADED.pop(lib, None)
            _build.build(lib)
            log = _build.BUILD_LOG.get(lib, (0, ""))[1].splitlines()
            recs = [{"site": n, "kind": p.kind, "class": int8_site_class(p),
                     **time_int8_site(p, xi, act, plain=False)}
                    for n, (p, xi, act) in seen.items() if p.kind == kind]
            classes, kernels = sum_int8_sites(recs)
            print(json.dumps({
                "kernel": lib, "cap": dict(zip(_CAP_MACROS[lib], cap)),
                "equal_to_plain": all(r["equal_to_plain"] for r in recs),
                "registers": sorted({int(ln.split("Used ")[1].split()[0]) for ln in log
                                     if "Used " in ln}),
                "spill_bytes_max": max([int(ln.split(",")[1].split()[0]) for ln in log
                                        if "spill stores" in ln] + [0]),
                "ms": kernels[kind]["ms"], "cold_ms": kernels[kind]["cold_ms"],
                "classes": {c: {"ms": v["ms"], "cold_ms": v["cold_ms"]}
                            for c, v in classes.items()}}), flush=True)
    _build.EXTRA_FLAGS.update(default)
    for lib in INT8_CAPS:
        _build._LOADED.pop(lib, None)


# ---- dw: the deploy depthwise kernel at every site of N's, S's and M's bf16 predict

DW_GRAPHS = ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m")
DW_SIDES = (8, 12, 16, 20, 24, 32, 40)


def dw_site_bound(x, k):
    """(bytes, operations, bound ms) of a deploy depthwise site: x in and the
    output out in x's dtype, the weights in x's dtype and an f32 bias once;
    2 operations a multiply-add, at the bf16 peak (portbench's rule)."""
    b, c, h, w = x.shape
    es = x.element_size()
    nbytes = 2 * b * c * h * w * es + c * k * k * es + 4 * c
    ops = 2 * b * c * h * w * k * k
    return nbytes, ops, max(nbytes / 3.35e12, ops / 989e12) * 1e3


def dw_deploy_inputs(site, batch, dev, dtype=torch.bfloat16):
    """x (offset 0.5: nonzero at every border), weights and a bias of the
    site's C and k, in dtype, from a seed of the site's shape."""
    c, h, w, k = site[:4]
    gen = torch.Generator(device=dev).manual_seed(c * 7 + h + k)
    x = (torch.randn((batch, c, h, w), generator=gen, device=dev) + 0.5) \
        .to(dtype).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((c, 1, k, k), generator=gen, device=dev) / k).to(dtype)
    bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
    return x, wt, bias


def dw_f32_result(x, wt, bias, act):
    """The plain version's f32 result of a site, before any rounding to x's
    dtype (x's and the weights' values are exact in f32)."""
    return DD.dw_conv_plain(x.float(), wt.float(), bias, act)


def dw_within_rounding(got, want):
    """got (bf16 or f32) within one rounding of its type of the f32 want,
    beside the f32 error of a sum in another order (1e-5 of the largest)."""
    tol = 2.0 ** -8 if got.dtype == torch.bfloat16 else 2.0 ** -23
    err = (got.float() - want.float()).abs()
    return bool((err <= tol * want.float().abs() + 1e-5 * want.float().abs().max()).all())


def dw_cold_ms(fn, sets):
    """Device ms of fn(x) on copies taken in turn, none in L2, replayed from
    a CUDA graph of two passes over them: a site takes some 10-150 us, less
    than the host needs to launch the op."""
    return graph_ms(sample.in_turn(fn, sets), 2 * len(sets))


def time_dw_site(x, wt, bias, act):
    """One deploy depthwise site on the card: the kernel checked against the
    plain version's f32 result (on the card), its warm ms (one input) and
    cold ms (dw_cold_ms), bound, and cuDNN's conv with the bias and act of
    the same shape, cold."""
    k = wt.shape[-1]
    got, want = DD.dw_conv(x, wt, bias, act), dw_f32_result(x, wt, bias, act)
    ok, err = dw_within_rounding(got, want), (got.float() - want).abs().max().item()
    del got, want
    sets = sample.cold_sets((x,))
    act_fn = DD.ACTS[act]
    nbytes, ops, bound = dw_site_bound(x, k)
    rec = {"shape": list(x.shape), "k": k, "act": act, "within_rounding": ok,
           "max_abs_err": err, "launches": 1,
           "tile": list(DD.dw_tile(k, *x.shape[2:], x.element_size())),
           "ms": graph_ms(lambda: DD.dw_conv(x, wt, bias, act)),
           "cold_ms": dw_cold_ms(lambda x: DD.dw_conv(x, wt, bias, act), sets),
           "library_ms": dw_cold_ms(lambda x: act_fn(torch.nn.functional.conv2d(
               x, wt, bias, 1, k // 2, 1, x.shape[1])), sets),
           "bytes": nbytes, "ops": ops, "bound_ms": bound}
    del sets
    return rec


def dw_tiles(k, h, w, esize):
    """The tiles of the sweep: square sides below the image, its halves and
    the whole image, each where its block fits in the card's shared memory."""
    tiles = [(s, s) for s in DW_SIDES if s < max(h, w)] + [(h, -(-w // 2)), (-(-h // 2), w),
                                                          (h, w)]
    return [t for t in dict.fromkeys(tiles) if DD.smem_bytes(k, *t, esize) <= DD.SMEM_MAX]


def dw(dev, dtype=torch.bfloat16):
    sums, swept, summed = {}, set(), {}
    esize = torch.empty((), dtype=dtype).element_size()
    for name in DW_GRAPHS:
        for site, count, front in sample.deploy_dw_sites(name, IMG, dev):
            c, h, w, k, act = site
            x, wt, bias = dw_deploy_inputs(site, BATCH, dev, dtype)
            rec = time_dw_site(x, wt, bias, act)
            print(json.dumps({"model": name, "site": list(site), "count": count,
                              "front_end": front, **rec}), flush=True)
            cls = f"{name} k{k} {h}px"
            agg = sums.setdefault(cls, {"sites": 0, "front_end": front, "cold_ms": 0.0,
                                        "library_ms": 0.0, "bound_ms": 0.0})
            agg["sites"] += count
            for key in ("cold_ms", "library_ms", "bound_ms"):
                agg[key] += count * rec[key]
            if (c, h, w, k) in swept:
                continue
            swept.add((c, h, w, k))
            sets = sample.cold_sets((x,))
            for tile in dw_tiles(k, h, w, esize):
                def run(xx, tile=tile):
                    return DD.dw_launch(xx, wt, bias, act, tile)
                ok = dw_within_rounding(run(x), dw_f32_result(x, wt, bias, act))
                ms = dw_cold_ms(run, sets)
                print(json.dumps({"site": list(site), "tile": list(tile), "within_rounding": ok,
                                  "picked": tile == DD.dw_tile(k, h, w, esize),
                                  "cold_ms": ms}),
                      flush=True)
                side = "whole" if tile == (h, w) else tile[0] if tile[0] == tile[1] else \
                    str(list(tile))
                summed.setdefault(f"k{k} {h}px", {}).setdefault(side, []).append(ms)
            del sets
    for cls, agg in sums.items():
        print(json.dumps({"class": cls, **agg,
                          "bound_over_kernel": agg["bound_ms"] / agg["cold_ms"]}), flush=True)
    print(json.dumps({"sweep_cold_ms_by_class": {
        c: {str(t): [sum(v), len(v)] for t, v in d.items()} for c, d in summed.items()}}),
        flush=True)


def _out_hw(p, x):
    h, w = x.shape[2:]
    return (h + 2 * p.pad - p.k) // p.stride + 1, (w + 2 * p.pad - p.k) // p.stride + 1


COMMANDS = {"frontend": frontend, "neck": neck, "dw_grad": dw_grad, "nms": nms, "stem": stem,
            "int8": int8, "int8_caps": int8_caps, "int8_3x3": int8_3x3, "dw": dw}

if __name__ == "__main__":
    args = sys.argv[1:]
    if args == ["dw_grad", "all"]:      # every cut of the sweep, not the best four
        args, COMMANDS["dw_grad"] = ["dw_grad"], lambda dev: dw_grad(dev, full=True)
    if args == ["dw", "f32"]:
        args, COMMANDS["dw"] = ["dw"], lambda dev: dw(dev, torch.float32)
    if len(args) != 1 or args[0] not in COMMANDS:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("tune_kernels: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False     # the plain versions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    COMMANDS[args[0]](torch.device("cuda:0"))
