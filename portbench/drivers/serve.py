"""Serve driver: one closed-loop client sends batches of uint8 BGR images
from pinned host memory to the program's predict and waits for the
detections on the host before it sends the next.

Set-up makes the folded weights on the card from the seed, conditions the
heads with the plain reference on CALIB_IMAGES seeded images
(reference/deploy.py:condition_heads: about `pairs_per_image` (anchor,
class) pairs an image clear conf_thres), draws
`distinct_batches` batches on the card and copies them to pinned host
memory, builds the program's predict for the mix's precision ("bf16":
Evaler.predict, CUDA graphs; "int8": core/quant.py's ptq_calibrate on
`ptq_batches` seeded batches, then int8_predict_fn, CUDA graphs), and runs
the predict once a distinct batch, which captures the one key the window
uses. The seconds from the process's start to the end of each stage of
set-up are kept as `setup_phases`.

The window cycles through the batches for --seconds. The client copies
each batch's detections into its pinned host buffers and waits for them, as
a serving framework with a pinned output pool does. serve_img_per_s is the
images whose detections reached the host over the window's host-clock
seconds; serve_batch_ms_p95 the 95th percentile of every batch's time from
the predict call to its detections on the host, read by CUDA events on the
card's clock (a batch takes some 15 ms, too short for the host's clock).

Once the window has closed and the peak memory is read, the program is
freed and `checked_batches` served batches, a reservoir sample of the
window's drawn from the seed, are held
against the plain reference (portbench/compare.py: detections), run in
f32 with TF32 off; for int8 the reference calibrates its own fake
quantization on the same batches the program calibrated on. The control,
for setting the limits, puts the reference one precision below in the
program's place (control()).
"""
from __future__ import annotations

import gc
import random
import time

import torch

from portbench import compare
from portbench.reference import deploy as R
from portbench.trace import Window, span

CALIB_IMAGES = 4     # seeded images the heads are conditioned on
# every key a serve mix may hold; run() refuses any other
MIX_KEYS = {"driver", "why", "precision", "batch", "img", "distinct_batches", "conf_thres",
            "iou_thres", "max_det", "multi_label", "pairs_per_image", "ptq_batches",
            "ptq_method", "checked_batches"}


def make_inputs(ctx, dev, phase=lambda name: None):
    """(reference model, device batches [n, B, H, W, 3], calibration
    batches for int8) from the seed."""
    mix, cfg = ctx.mix, ctx.config
    model = R.Model(cfg, None)
    model.sd = R.random_weights(model.layers, ctx.sub_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(1))
    img, b = mix["img"], mix["batch"]

    def draw(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
    calib = draw(CALIB_IMAGES, img, img, 3)
    batches = draw(mix["distinct_batches"], b, img, img, 3)
    ptq = draw(mix.get("ptq_batches", 0), b, img, img, 3)
    phase("weights")
    with compare.plain_f32():
        R.condition_heads(model, calib, mix["pairs_per_image"])
    return model, batches, ptq


def build_program(ctx, model, ptq, dev, phase=lambda name: None):
    """-> (predict of host uint8 images, its PredictGraphs or None)."""
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    mix, cfg = ctx.mix, ctx.config
    tree = state_dict_to_train_variables({f"net.{k}": v for k, v in model.sd.items()})
    thr = dict(conf_thres=mix["conf_thres"], iou_thres=mix["iou_thres"], max_det=mix["max_det"])
    if mix["precision"] == "bf16":
        from mafyolo_tpu_torch.core.evaler import Evaler
        ev = Evaler(half=True, device=dev, **thr)
        ev.init_model(cfg["graph"], {"params": tree["params"]}, nc=cfg["nc"], folded=True)
        return (lambda x: ev.predict(x, multi_label=mix["multi_label"])), ev.graphs
    if mix["precision"] == "int8":
        from mafyolo_tpu_torch.core.quant import int8_predict_fn, ptq_calibrate
        params = {"params": tree["params"]}
        quant = ptq_calibrate(cfg["graph"], cfg["nc"], params, list(ptq),
                              max_batches=len(ptq), method=mix["ptq_method"], device=dev)
        phase("ptq")
        fn = int8_predict_fn(cfg["graph"], cfg["nc"], params, quant, device=dev, **thr)
        return (lambda x: fn(x, multi_label=mix["multi_label"])), fn.graphs
    raise ValueError(f"unknown precision {mix['precision']!r}")


def counters():
    from mafyolo_tpu_torch.ops import frontend, greedy_nms, quant_conv
    return {"frontend": frontend.frontend_forward.launches,
            "greedy_nms": greedy_nms.greedy_nms.launches,
            "int8_conv": quant_conv.int8_conv.launches,
            "int8_dw": quant_conv.int8_dw.launches}


def run(ctx):
    unknown = set(ctx.mix) - MIX_KEYS
    if unknown:
        raise ValueError(f"the serve driver does not read {sorted(unknown)}")
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    mix = ctx.mix
    phases = dict(getattr(ctx, "marks", {}))   # imports, from the harness

    def phase(name):
        if on_card and name != "start":
            torch.cuda.synchronize(dev)
        phases[name] = time.perf_counter() - ctx.t_start
    phase("start")
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
    phase("cuda")
    model, batches, ptq = make_inputs(ctx, dev, phase)
    phase("heads")
    host = batches.cpu().pin_memory() if on_card else batches.cpu()
    del batches                # the check takes its batches from the host copy
    phase("pinned")
    predict, graphs = build_program(ctx, model, ptq, dev, phase)
    phase("program")
    buffers = {}             # the client's host buffers, pinned on the card

    def serve(i):
        with span("predict"):
            out = predict(host[i % len(host)])
        with span("to_host"):
            for k, v in out.items():
                if k not in buffers:
                    buffers[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=on_card)
                buffers[k].copy_(v, non_blocking=on_card)
            if on_card:
                torch.cuda.current_stream(dev).synchronize()
        return buffers
    for i in range(len(host)):           # warm-up: the window's one key
        serve(i)
    phase("warm")
    setup_s = time.perf_counter() - ctx.t_start

    before, captures = counters(), graphs.captures if graphs is not None else 0
    # the batches to check: a reservoir sample of the window's, drawn from
    # the seed, so that the client holds a few and not all
    rng, checked, kept, marks = random.Random(ctx.sub_seed(2)), [], [], []
    with Window(ctx.trace) as win:
        t0 = time.perf_counter()
        while True:
            i = len(marks)
            with span("batch"):
                start = _event(on_card)
                dets = serve(i)
                marks.append((start, _event(on_card)))
            kept += dets["valid"].sum(1).tolist()
            slot = i if i < mix["checked_batches"] else rng.randint(0, i)
            if slot < mix["checked_batches"]:
                pick = (i % len(host), {k: v.clone() for k, v in dets.items()})
                checked[slot:slot + 1] = [pick]
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        t1 = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
    n = len(marks)
    window_s = t1 - t0
    lat = sorted(a.elapsed_time(b) for a, b in marks) if on_card else [0.0]
    result = {
        "e2e": {"serve_img_per_s": n * mix["batch"] / window_s,
                "serve_batch_ms_p95": compare.percentile(lat, 95), "setup_s": setup_s},
        "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else 0,
        "attempted": n, "failed": 0, "setup_phases": phases}
    after = counters()
    record = {"batches": n, "images": n * mix["batch"], "window_s": window_s,
              "batch": mix["batch"], "img": mix["img"], "precision": mix["precision"],
              "kept_per_image": kept, "config": ctx.config,
              "counters": {k: after[k] - before[k] for k in after}}
    record["counters"]["captures"] = (graphs.captures if graphs is not None else 0) - captures
    if ctx.trace:
        record.update(win.reduce(window_s))
        result["busy_s"], result["window_s"] = record["busy_s"], window_s
        result["breakdown"] = record["breakdown"]
    result["record"] = record

    # the check, once the window has closed and the program is freed
    checked = [(host[b].to(dev), dets) for b, dets in checked]
    del predict, graphs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with compare.plain_f32():
        quant = model.calibrate(8, ptq) if mix["precision"] == "int8" else None
        numbers = compare.detections(model, checked, mix, quant)
    result["numbers"], result["checks"] = numbers, compare.held(numbers, ctx.limits)
    return result


def control(ctx):
    """The control's numbers: the reference one precision below the mix's
    (bf16 -> float8 e4m3, int8 -> int4), its own NMS'd detections put in the
    program's place, on the batches a run would check (the first
    `checked_batches` distinct ones), held against the reference."""
    dev = torch.device(ctx.device)
    mix = ctx.mix
    model, batches, ptq = make_inputs(ctx, dev)
    imgs = [batches[i] for i in range(min(mix["checked_batches"], len(batches)))]
    with compare.plain_f32():
        if mix["precision"] == "int8":
            quant, low = model.calibrate(8, ptq), model.calibrate(4, ptq)
        else:
            quant, low = None, model.calibrate("fp8", imgs)
        return compare.detections(model, [(x, None) for x in imgs], mix, quant, control=low)


def _event(on_card):
    if not on_card:
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e
