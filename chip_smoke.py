#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mafyolo_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without a result line:
  1. device     a CUDA card is present; print its name and power limit;
  2. build      nvcc-build the hand-written kernels from mafyolo_tpu_torch/csrc;
                cuobjdump -sass of the front-end, neck and stem libraries must
                hold tensor-core instructions (HMMA or HGMMA), the int8 conv
                library IMMA ones (mma.sync) and IGMMA ones (the 3x3
                stride-1 kernel's warpgroup MMA);
  3. frontend   the fused front-end kernel against its plain version
                (N bs4@640, S and M bs2@640, a 256x64 N batch, and 200x168
                batches of N, S and M, whose H/4 = 50 and W/4 = 42 no tile
                divides; f32 and bf16);
  4. nms        the greedy-NMS kernel against its plain version, keep sets
                exactly equal: B=32 at M=512 and M=2000, B=8 at M = 1, 63, 64,
                65, 256, 512 and 2000, an image with no valid box, identical
                boxes, a suppression chain and pairs at the threshold;
  5. dw_grad    the depthwise weight-gradient kernel against its plain
                version at every (C, H, k) of N's train graph at B=2, plus a
                dilation-2 case, C of 1, 33 and 72 on 37x23 and 1x1 images
                and paddings that make Ho != H; f32 and bf16, twice for the
                bits; a launch over the block's shared memory must raise;
  6. stem       the stem kernel against its plain version for N, S and M
                weights at bs2@640 and at 2x66x130 (odd H/2 and W/2 tails,
                390-byte rows): f32 within 1e-3, bf16 within one bf16
                rounding of the f32 result, a second launch bit-identical;
  7. slice      MAF-YOLO-N deploy Evaler.predict in bf16, bs32 uint8 @640,
                for BATCHES batches plus one batch that overflows into the
                dense NMS path, with every kernel's launch count read around
                that run; then the card in f32 against the CPU plain path on
                2 images @640 and on one 2x126x94 batch (conf 0.001), which
                takes the model's own layers 0-2 (no front-end launch);
                the bf16 predict of a bs32 batch against the f32 predict
                of it, by the front-end route and by the stem route;
  8. neck (N)   the neck kernel against its plain version on the real
                layer-20 input of N's bs32@640 forward; the plain version
                against the model's own layers 19-22;
  9. timings    CUDA-event times: N e2e img/s and p50 batch latency at
                bs32@640, its decode + NMS stage split into parts, and each
                kernel beside its plain version (NMS also on the candidates
                of a real predict, and replayed from a CUDA graph); the
                front-end kernel for N, S and M at bs32@640 in bf16 beside the
                deploy model's own layers 0-2 (bf16 cuDNN, flip, cast and /255
                included);
 10. slice_s    MAF-YOLO-S deploy in bf16, BATCHES batches of bs32 uint8
                @640 through stem_apply -> fused_decode_nms, the neck kernel
                run on each batch's layer-20 input, launch counts read
                around that run; in f32 on the card, one bs32 batch's
                detections matched against the front-end route
                (Evaler.predict), and 2 images' against the CPU plain path;
                each bf16 route against the f32 predict of the same batch,
                and each route's layer-2 output against f32 layers 0-2;
 11. neck (S, M)  the neck kernel against its plain version on S's real
                layer-20 input at bs32 and on random M inputs at bs2;
 12. timing_s   S img/s, p50 and p90 through the stem route and through the
                front-end route, each split into stages; the neck kernel
                beside its plain version (at S and N, and beside the
                model's own layers 19-22); the FMA probe's kernel
                and plain chains at [32768, 1536] (its tool entry point);
 13. slice_m    MAF-YOLO-M deploy in bf16, M_BATCHES batches of bs32 uint8
                @640 through Evaler.predict with the front-end and NMS
                launch counts read around that run; card f32 against the
                CPU plain path on 2 images; bf16 against f32; img/s, p50 and
                the stage split; then every bf16-against-f32 share (N, S by
                both routes, M) against its floor, BF16_SHARE_FLOOR;
 14. timing_stem  the stem kernel for N, S and M at bs32@640: its gates,
                then its time (bf16 and f32), its plain version's and the
                model's own layer 0's, each call on the next of enough
                copies of the input that none is in L2; then timing_dw:
                the deploy depthwise kernel at every depthwise site of N,
                S and M at bs32@640, within one bf16 rounding of its plain
                version, timed the same way beside cuDNN's conv with its
                bias and activation, by class (k, side);
 15. train      MAF-YOLO-N train steps at bs32@640 in bf16 through the
                Trainer's step loop on a COCO epoch's step schedule
                (accumulate 2: accumulate-only and apply steps alternate;
                ATSS epoch, then TAL epoch) on batches made on the card, with
                the dw_grad launch count read around that run;
 16. train_check  one f32 step of N at bs2@160 on the card against the CPU
                plain path: loss components, every gradient, BN stats;
 17. train_to_serve  the EMA folded into the deploy model, Evaler.predict;
                the folded model in f32 against the train form in eval mode
                on the same EMA weights (every head's inner outputs);
 18. timing_train  train-step img/s and its stage split; the device's busy
                time and idle share over two profiled steps; the dw_grad
                kernel against its plain version at every DW site at B=32
                (values and determinism), and the summed dk time per step,
                kernel against plain and against aten's convolution_backward
                (weight gradient only), by eager calls and from a CUDA graph,
                split by class of site (H, k);
 19. eval       MAF-YOLO-N through the eval loop: 70 images of EVAL_SIZES
                held in memory (utils/sample.py:ArrayDataset; the machine
                has no image decoder) -> letterbox -> DataLoader (8
                threads) -> Evaler.predict_model -> COCOEvaluator, the
                front-end and NMS launches read around it. Gates: the card
                in f32 against the CPU on 4 images (95% matched); run_eval
                in f32 against labels made from the card's own f32
                detections (AP50 >= 0.99, AP >= 0.95); rect batches (one
                front-end launch a batch, the kernel against its plain
                version at every shape met); bf16 run_eval on those labels
                at least EVAL_BF16_AP_FLOOR; the short last batch (6
                images) through both kernels, detections in each image.
                Then the loop's img/s (bf16, loader included), its h2d /
                infer + NMS / post split and the device's idle share (one
                profiled loop), beside Evaler.predict alone.
 20. trainer    MAF-YOLO-N trained through the Trainer end to end with
                --device-aug: 72 images held in memory (batches of 32, 32
                and 8) through the loader and device_augment into the step,
                the eval phase's images evaluated by run_eval on the EMA,
                checkpoints; Trainer A runs epochs 0-1, Trainer B resumes
                from A's last_ckpt.npck and trains epochs 2-3, evaluates
                and strips (trainer_phase's docstring lists the gates).
                Then the trainer's img/s, device_augment's and the step's
                ms, the device's idle share over a profiled epoch.
 21. quant      MAF-YOLO-N served in real int8 (quant_phase's docstring
                lists the gates): PTQ calibration at bs32@640 (max, card vs
                CPU, percentile), the int8 conv kernels against their plain
                versions bit for bit at every distinct site and odd shapes,
                with and without the fused activation, and the fused SiLU
                on every finite bf16 value, int8_predict_fn with the launch
                counts read around it (66 int8_conv, 16 int8_dw, NMS, no
                front-end), int8 against fake-quant and the CPU, that share
                split into its quant and dtype effects, two QAT steps,
                tools/quantize.run --eval on images held in memory, then
                the img/s of int8-real, int8-sim and bf16 and each int8
                kernel by site and class of site, warm and cold.
 22-24. sm_train, bridge, ddp  S and M training, reference `.pt`
                checkpoints, data parallel (each phase's docstring lists
                its gates).
 25. recipes    MAF-YOLO-N's training recipes (recipes_phase's docstring
                lists the gates): two bs32@640 bf16 steps each under giou,
                diou, ciou, siou, wiou, distillation, SimOTA and repopt
                through the Trainer's step, the dw_grad launches read
                around them, and each step's ms beside giou's; each recipe's
                f32 step card against CPU; a distillation Trainer and a
                repopt + Wise-IoU Trainer for an epoch on images held in
                memory, evaluated, the repopt EMA served; SimOTA's decode
                through batched_nms.
 26. office     the YOLOv6 office graphs N, M and L at full width
                (office_phase's docstring lists the gates): served at
                bs32@640 bf16 through Evaler.predict (N and M by the
                front-end's layers-0-1 mode, one launch a predict; L by its
                own layers), the layers-0-1 kernel against its plain version
                and the model's own layers 0-1, f32 card against CPU, bf16
                against f32, img/s and the kernel's times; office N trained
                by the Trainer for an epoch with --device-aug, evaluated,
                resumed bit for bit, its EMA served; an f32 step card
                against CPU; an M step at bs8@640.
 27. export_quant  S, M and the office graphs N, M and L served in real
                int8 at bs32@640 (export_quant_phase's docstring lists the
                gates): the 3x3 stride-1 kernel's quantizer and fused SiLU
                on every finite bf16 value; calibrated on the card (f64
                card against CPU), every distinct int8 site bit-equal to
                its plain version, int8_predict_fn with the int8 and NMS
                launches read around it (every office 3x3 stride-1 site
                on csrc/int8_conv3x3.cuh), the share of int8-sim detections
                matched, img/s beside bf16, the office 3x3 stride-1 class
                (beside its time before it had its own kernel) and S's
                and M's depthwise sites timed by class; N exported by tools/export.py
                (--end2end, none and int8) on the card, loaded, run and
                held to the eager function bit for bit, its launches
                counted; tools/flops.py's line for N, S and M.
 28. remat      per-block rematerialization (remat_phase's docstring lists
                the gates): N, M and the YOLOv6-L office graph at bs32@640
                bf16 through make_train_step, without remat, under "full"
                and under "convs": each mode's steps from one state held to
                the run without remat (bit-equal where two runs without
                remat are, else within twice their spread), peak memory,
                step ms p50 and p90, dw_grad launches a step, the device's
                busy share; office L's f64 step card against CPU and a
                Trainer epoch with --remat; the train CLI with --remat.
 29. overfit    MAF-YOLO-N trained to boxes (tools/overfit.py: the JAX
                package's synthetic overfit, 256 images at 640 made from a
                seed, 3 classes) through the Trainer at bs32@640 bf16 with
                --device-aug for the first OVERFIT_STEPS steps of its
                960-step run, the EMA evaluated every 10 epochs; its best
                checkpoint then served on every path and gated by AP on 64
                held-out images (f32, bf16 graphs, int8-sim and int8-real,
                the exported programs) and by the detection shares of bf16
                and int8 on trained heads (overfit_phase's docstring lists
                the gates).
 graphs         every serving path on the card is one CUDA-graph replay a
                predict (core/graphs.py): in phases 7, 10, 13, 21, 26 and 27
                each path (bf16 N, S, M, office N, M, L; int8 N, S, M, office
                N, M, L; bs32@640) gets a `graphs` line (graphs_check's
                docstring): its graph against its eager predict bit for bit
                (overflow batch, multi_label=False, 2x126x94, a second
                replay, its keys replayed out of their capture order),
                launch counts equal, the kernels the profiler saw equal to
                the counters on both routes, and both routes' img/s, mean,
                p50 and p90 batch ms, device busy ms and idle share, with
                each key's warm-up and capture ms and pool bytes. The
                paths' timing lines read the graph route's times from it.
                An overflow batch launches 1 + 8 NMS kernels on both routes.
Each entry of the "kernels" line carries bound_ms, the least time the card
could take: the larger of the bytes moved (inputs read once, outputs written
once) over 3.35 TB/s and the operations over the peak rate of the operand
type (989 TFLOP/s for bf16 and uint8 operands, 67 TFLOP/s for f32, 1979
TOP/s for the int8 convs), and
library_ms where PyTorch's own layers or one aten call compute the same.
Weights are random (seeded); the deploy cls_pred layers are rescaled so that
an image has about 150 (anchor, class) pairs above conf 0.03; the train run
starts from the model's own initialization. Nothing here imports JAX. The
last line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, IMG, BATCHES, NC = 32, 640, 20, 80
M_BATCHES = 4              # MAF-YOLO-M predicts at bs32@640
# The least share of the f32 predict's detections that the bf16 predict of
# the same batch must match (match()'s criterion): 0.6 x the lowest share
# measured (PERF.md §6, the stem kernel's entry; NVIDIA H100 80GB HBM3,
# 700.00 W). Random heads
# rescaled to fire move bf16 scores by 0.013-0.056 on average there, past
# the 0.01 of the criterion, so the levels are low, and a change in the last
# bit of some layer-0 values moved a share by up to 29% of its level (N's
# stem route, 24 -> 17 of 488); a route that broke would fall to 0.
BF16_SHARE_FLOOR = {"n_frontend": 0.063, "n_stem": 0.020, "s_stem": 0.182,
                    "s_frontend": 0.187, "m_frontend": 0.309}
# The eval phase's images (h, w) and how many of each: the long side at IMG
# (no resize: the card's machine has no cv2), 70 in all, so bs 32 makes
# batches of 32, 32 and 6; by aspect ratio the rect batches come out
# 512x672, 672x672 and 672x448 at IMG 640.
EVAL_SIZES = {(IMG, IMG): 14, (IMG * 3 // 4, IMG): 12, (IMG, IMG * 3 // 4): 12,
              (IMG * 9 // 16, IMG): 20, (IMG, round(IMG / 1.5)): 12}
# The least bf16 eval AP50 and AP against the f32 run's own detections: 0.6
# x the first card run's, 0.5874 and 0.4714 (PERF.md §6, the eval loop's
# entry; NVIDIA H100 80GB HBM3, 700.00 W), for the reason BF16_SHARE_FLOOR
# gives.
EVAL_BF16_AP_FLOOR = {"AP50": 0.352, "AP": 0.282}
STEPS_PER_EPOCH = 3665     # COCO train2017 (117266 images) at bs 32
TRAIN_STEPS = 4            # per epoch: an ATSS epoch, then a TAL epoch
TRAIN_IMAGES = 72          # the trainer phase's set: batches of 32, 32 and 8
# sm_train: (graph, batch) at IMG in bf16, and each one's (do_apply,
# use_atss) steps: accumulate 2, ATSS then TAL for S, two steps for M
SM_TRAIN = (("maf-yolo-s", 16, ((False, True), (True, True), (False, False), (True, False))),
            ("maf-yolo-m", 8, ((False, True), (True, True))))
# ddp: two ranks on the one card, each DDP_BATCH images of DDP_IMG, N in
# f32; an apply step, then an accumulate-only step and an apply step
DDP_IMG, DDP_BATCH, DDP_WORLD = 320, 4, 2
DDP_TIMED_STEPS = 3
# recipes: the epoch of the recipe steps (TAL; distillation's decay at
# 4 / 300 of the way) and the images of its two Trainer epochs
RECIPE_EPOCH = 4
RECIPE_IMAGES = 72
# device_augment on the card against the CPU on the same draw: the f32
# bilinear taps differ by rounding only (one 8-bit level is 1/255)
DEVICE_AUG_TOL = 1.0 / 255


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


T0 = time.perf_counter()


def emit(**kw):
    """One JSON line; "t" is the seconds since the script started."""
    print(json.dumps({**kw, "t": round(time.perf_counter() - T0, 1)}), flush=True)


HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}   # H100 SXM data sheet, dense
SM_CLOCK_HZ, SMEM_ROUND_TRIP_CLOCKS = 1.755e9, 33   # boost clock; a dependent shared load


def bound(nbytes, flops, kind):
    """{"bound_ms", "bound_by"}: the least time the card could take."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def frontend_bound(cfg, b, h, w, out_bytes=2):
    """Layers 0-2 (0-1 at depth 0) without halo recompute: uint8 image in,
    [b, h/4, w/4, cout] out, the weights once; 2 FLOPs per multiply-add of
    every conv."""
    c0, c1, c_, mid, depth, c2 = cfg.dims()     # depth 0: layers 0-1, c_ = mid = c2 = 0
    p0, p1 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
    fma = p0 * 27 * c0 + p1 * (9 * c0 * c1 + c1 * 2 * c_ + depth * (2 * c_ * mid + 9 * mid)
                               + (2 + depth) * c_ * c2)
    weights = 4 * (27 * c0 + 9 * c0 * c1 + c1 * 2 * c_ + depth * (2 * c_ * mid + 9 * mid)
                   + (2 + depth) * c_ * c2)
    return bound(b * h * w * 3 + p1 * cfg.cout * out_bytes + weights, 2 * fma, "bf16")


def neck_bound(cfg, b, elem_bytes=2):
    """Layers 19-22: three sources in, y20 and y22 out, the weights once."""
    p = b * cfg.h * cfg.h
    fma = wts = 0
    for cin, c_, mid, depth, cout in ((sum(cfg.cins), cfg.c1_, cfg.mid1, cfg.d1, cfg.c20),
                                      (cfg.c20 + cfg.cins[2], cfg.c2_, cfg.mid2, cfg.d2, cfg.c22)):
        per_px = cin * 2 * c_ + depth * (2 * c_ * mid + 25 * mid) + (2 + depth) * c_ * cout
        fma += p * per_px
        wts += 4 * per_px
    return bound(p * (sum(cfg.cins) + cfg.c20 + cfg.c22) * elem_bytes + wts, 2 * fma,
                 "bf16" if elem_bytes == 2 else "f32")


def model_layers0_2(model, dtype):
    """The deploy model's own layers 0-2 on uint8 BGR NHWC images, with the
    flip, the cast and /255 of Evaler.forward's other branch."""
    net = model.net

    def run(imgs):
        x = (imgs.flip(-1).to(dtype) / 255.0).permute(0, 3, 1, 2)
        return net.layer2(net.layer1(net.layer0(x)))
    return run


def tensor_core_check(paths):
    """cuobjdump -sass of the built front-end, neck and stem libraries must
    hold HMMA or HGMMA instructions, and the int8 conv library IMMA ones
    (mma.sync.m16n8k32, int8_conv.cu) and IGMMA ones (wgmma.mma_async
    m64nNk32 s8, int8_conv3x3.cuh); a missing cuobjdump fails."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(tool), "cuobjdump not found: cannot show the tensor-core instructions")
    for name in ("frontend", "neck80", "stem", "int8_conv"):
        proc = subprocess.run([tool, "-sass", str(paths[name])], capture_output=True,
                              text=True, timeout=300)
        check(proc.returncode == 0, f"cuobjdump failed on {name}: {proc.stderr[-300:]}")
        count = {op: sum(f" {op}." in ln for ln in proc.stdout.splitlines())
                 for op in ("HMMA", "HGMMA", "IMMA", "IGMMA")}
        emit(phase="tensor_cores", kernel=name, lib=os.path.relpath(paths[name], HERE),
             **{f"{op.lower()}_instructions": v for op, v in count.items()})
        check(sum(count.values()) > 0, f"{name}: no HMMA, HGMMA or IMMA instruction in its SASS")
        if name == "int8_conv":
            check(count["IMMA"] > 0 and count["IGMMA"] > 0,
                  f"int8_conv: want IMMA and IGMMA instructions in its SASS, got {count}")


def train_batch(seed, b, img, device, max_boxes=120):
    """utils/sample.py:train_batch: uint8 images and padded targets made on
    the device from a seed."""
    from mafyolo_tpu_torch.utils.sample import train_batch as make
    return make(seed, b, img, device, max_boxes, NC)


def dw_grad_phase(dev):
    """Phase 5: the dw_grad kernel against its plain version at every DW site
    of N's train graph at B=2, the dilation-2 k9 case at H=20, C of 1, 33 and
    72 on 37x23 and 1x1 images, and paddings other than (k-1)d/2 (Ho != H);
    f32 and bf16, twice for the bits. A launch that asks for more shared
    memory than a block may have must raise. Returns the largest error."""
    import torch

    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.utils.sample import dw_sites
    cl = torch.channels_last
    torch.manual_seed(0)
    sites = dw_sites(build_model("maf-yolo-n", nc=NC).to(dev).to(memory_format=cl), IMG, dev)
    cases = sorted(set(sites)) + [
        (64, 20, 20, 9, 8, 2), (48, 37, 23, 5, 2, 1), (1, 37, 23, 5, 2, 1), (33, 37, 23, 3, 1, 1),
        (72, 37, 23, 9, 4, 1), (72, 1, 1, 3, 1, 1), (33, 1, 1, 1, 0, 1), (72, 37, 23, 7, 3, 1),
        (40, 26, 31, 3, 0, 1), (40, 26, 31, 5, 4, 1), (40, 26, 31, 1, 2, 1), (40, 26, 31, 9, 2, 1)]
    dk_err = dw_grad_gate(dev, cases)
    # k = 9 at dilation 25 stages at least 201 x 210 x 32 f32 values: over
    # the block's shared memory, and the wrapper must raise, not fall back
    x = torch.zeros((1, 8, 200, 200), device=dev).contiguous(memory_format=cl)
    try:
        DG.dw_grad(x, x, 9, 100, 25)
    except RuntimeError as e:
        emit(phase="dw_grad_too_large", raised=str(e)[:120])
    else:
        fail("dw_grad: a launch over the block's shared memory did not raise")
    emit(phase="dw_grad_sites", sites=len(sites), distinct=len(set(sites)), cases=len(cases))
    return dk_err


def dw_grad_gate(dev, cases, phase="dw_grad_check", **tags):
    """The dw_grad kernel against its plain version at each (C, H, W, k, pad,
    dilation) of cases at B=2, f32 and bf16, twice for the bits; -> the
    largest error."""
    import torch

    from mafyolo_tpu_torch.ops import _build
    from mafyolo_tpu_torch.ops import dw_grad as DG
    cl = torch.channels_last
    dk_err = 0.0
    for c, h, w, k, pad, dil in cases:
        ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
        gen = torch.Generator(device=dev).manual_seed(c * 1000 + h * 10 + k)
        # an offset keeps x nonzero at every border
        x32 = (torch.randn((2, c, h, w), generator=gen, device=dev) + 0.5) \
            .contiguous(memory_format=cl)
        g32 = torch.randn((2, c, ho, wo), generator=gen, device=dev).contiguous(memory_format=cl)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            x, g = x32.to(dt), g32.to(dt)
            want = DG.dw_grad_plain(x, g, k, pad, dil)
            got = DG.dw_grad(x, g, k, pad, dil)
            again = DG.dw_grad(x, g, k, pad, dil)
            err = (got - want).abs().max().item()
            bound = 1e-3 * want.abs().max().item()
            errs[str(dt).split(".")[1]] = (err, bound)
            check(err <= bound, f"dw_grad kernel vs plain {dt} C{c} H{h} W{w} k{k} p{pad} d{dil}: "
                                f"{err} > {bound}")
            check(torch.equal(got, again), f"dw_grad not deterministic C{c} H{h} k{k}")
            dk_err = max(dk_err, err)
        cut = DG.plan(2, c, ho, wo, k, pad, dil, 2, _build.sm_count(dev.index))
        emit(phase=phase, **tags, c=c, h=h, w=w, k=k, pad=pad, dilation=dil, batch=2,
             cut_bf16=cut._asdict(),
             max_abs_err_f32=errs["float32"][0], bound_f32=errs["float32"][1],
             max_abs_err_bf16=errs["bfloat16"][0], bound_bf16=errs["bfloat16"][1],
             tolerance="1e-3 * max|plain| for both; bf16 inputs are the same "
                       "numbers for both versions, each accumulates in f32")
    return dk_err


def stem_route(name, folded, half, dev):
    """The stem kernel's route: a deploy model built with skip_stem=True
    (layers 1-33) and the packed stem weights; predict(imgs) runs
    stem_apply -> fused_decode_nms with the Evaler's thresholds."""
    import torch

    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops.nms import fused_decode_nms
    from mafyolo_tpu_torch.ops.stem import stem_apply, stem_build
    from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict
    model = build_model(name, nc=NC, deploy=True, skip_stem=True)
    model.load_state_dict(folded_to_state_dict(folded))
    model = model.to(dev).eval()
    sw = stem_build(model.net)
    model = model.to(dtype=torch.bfloat16 if half else torch.float32,
                     memory_format=torch.channels_last)

    def predict(imgs):
        with torch.no_grad():
            return fused_decode_nms(stem_apply(model, sw, imgs), strides=model.strides,
                                    reg_max=model.reg_max)
    return model, sw, predict


def decode_nms_split(heads, iters=10):
    """Mean CUDA-event ms of each part of fused_decode_nms(heads) on its fast
    path, in stage order, without touching the stage's code: events are
    recorded around the stage, at the entry of the DFL decode and of the
    final select, around the NMS wrapper and around the one Tensor.item()
    it makes (the overflow flag's host read, after the fast stage). A part's
    time includes the gaps in which the card waits for the host to launch
    that part's small kernels."""
    import torch

    from mafyolo_tpu_torch.ops import nms as NMS
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][name] = ev

    def wrap(fn, before, after=None):
        def run(*a, **kw):
            mark(before)
            out = fn(*a, **kw)
            if after:
                mark(after)
            return out
        return run

    real = (NMS.greedy_nms, NMS._blocked_greedy_select, NMS.dfl_decode, torch.Tensor.item)
    NMS.greedy_nms = wrap(real[0], "nms_in", "nms_out")
    NMS._blocked_greedy_select = wrap(real[1], "select_in")
    NMS.dfl_decode = wrap(real[2], "decode_in")
    torch.Tensor.item = wrap(real[3], "sync_in", "sync_out")
    try:
        for i in range(iters + 2):
            marks.append({})
            mark("start")
            NMS.fused_decode_nms(heads)
            mark("end")
    finally:
        NMS.greedy_nms, NMS._blocked_greedy_select, NMS.dfl_decode, torch.Tensor.item = real
    torch.cuda.synchronize()
    parts = {"compaction_top2_sort_ms": ("start", "decode_in"),
             "dfl_decode_ms": ("decode_in", "select_in"),
             "select_before_nms_ms": ("select_in", "nms_in"), "nms_kernel_ms": ("nms_in", "nms_out"),
             "final_select_ms": ("nms_out", "sync_in"), "host_sync_ms": ("sync_in", "sync_out"),
             "total_ms": ("start", "end")}
    return {k: sum(m[a].elapsed_time(m[b]) for m in marks[2:]) / iters
            for k, (a, b) in parts.items()}


def match(ref, got, min_score, unmatched=None):
    """(reference detections with score > min_score, how many of them have a
    detection in `got` of the same class, IoU >= 0.9 and |dscore| <= 0.01);
    both are predict() dicts, on the CPU. Given a list `unmatched`, append
    (image, box, class, score) of each reference detection left unmatched."""
    from mafyolo_tpu_torch.ops.boxes import box_iou_pairwise
    n_ref = matched = 0
    for i in range(ref["valid"].shape[0]):
        sel = ref["valid"][i] & (ref["scores"][i] > min_score)
        gv = got["valid"][i]
        iou = box_iou_pairwise(ref["boxes"][i][sel], got["boxes"][i][gv])
        same = ((ref["classes"][i][sel][:, None] == got["classes"][i][gv][None])
                & ((ref["scores"][i][sel][:, None] - got["scores"][i][gv][None]).abs() <= 0.01)
                & (iou >= 0.9))
        n_ref += int(sel.sum())
        matched += int(same.any(1).sum())
        if unmatched is not None:
            miss = ~same.any(1)
            unmatched += [(i, bx, int(c), float(sc)) for bx, c, sc in zip(
                ref["boxes"][i][sel][miss], ref["classes"][i][sel][miss],
                ref["scores"][i][sel][miss])]
    return n_ref, matched


def check_dets(outs, b, what):
    """Shapes, finite values, a detection in every image, scores descending."""
    import torch
    for o in outs:
        v = o["valid"]
        check(o["boxes"].shape == (b, 300, 4) and bool(torch.isfinite(o["boxes"]).all())
              and bool(torch.isfinite(o["scores"]).all()), f"{what}: non-finite or misshaped output")
        check(int(v.sum(1).min()) > 0, f"{what}: an image has no detection")
        s = torch.where(v, o["scores"], torch.zeros_like(o["scores"]))
        check(bool((s[:, 1:] <= s[:, :-1]).all()), f"{what}: scores not descending")


def on_cpu(out):
    return {k: v.cpu() for k, v in out.items()}


def bf16_vs_f32(tag, ref32, got16, heads32=None, heads16=None):
    """The share of the f32 predict's detections (score > 0.1) that the bf16
    predict of the same batch matches under match()'s criterion, and, given
    both forwards' head outputs, how far the bf16 scores moved from the f32
    ones over the (anchor, class) pairs whose f32 score is above 0.1."""
    import torch
    n, m = match(on_cpu(ref32), on_cpu(got16), 0.1)
    rec = {"route": tag, "f32_dets_above_0p1": n, "matched": m, "share": m / max(n, 1)}
    if heads32 is not None:
        d = torch.cat([(g[1].float() - r[1].float()).abs()[r[1].float() > 0.1]
                       for r, g in zip(heads32, heads16)])
        rec.update(score_pairs=d.numel(), dscore_max=d.max().item(),
                   dscore_mean=d.mean().item(), dscore_over_0p01=(d > 0.01).float().mean().item())
    emit(phase="bf16_vs_f32", **rec)
    return rec


def rel_err(got, want):
    """(max |got - want| / max |want|, mean |got - want| / mean |want|)."""
    d, w = (got.float() - want.float()).abs(), want.float().abs()
    return d.max().item() / w.max().item(), d.mean().item() / w.mean().item()


def stem_gate(x, sw, what):
    """The stem kernel against stem_plain (f32) on x: f32 within 1e-3; bf16
    within one bf16 rounding of the f32 result (|got - want| <= 1e-6 +
    2^-8 |want|: rtol 2^-8 is the worst relative error of rounding to
    bf16); a second launch of each bit-identical. Returns (max f32 error,
    max bf16 error, mean bf16 error, the largest ratio of the bf16 error to
    its allowance)."""
    import torch

    from mafyolo_tpu_torch.ops import stem as S
    want = S.stem_plain(x, sw)
    got32, got16 = S.stem_conv_s2(x, sw, torch.float32), S.stem_conv_s2(x, sw, torch.bfloat16)
    same = (torch.equal(got32, S.stem_conv_s2(x, sw, torch.float32))
            and torch.equal(got16, S.stem_conv_s2(x, sw, torch.bfloat16)))
    e16 = (got16.float() - want).abs()
    ratio = (e16 / (1e-6 + 2 ** -8 * want.abs())).max().item()
    errs = ((got32 - want).abs().max().item(), e16.max().item(), e16.mean().item(), ratio)
    check(torch.allclose(got32, want, atol=1e-3, rtol=1e-3),
          f"{what}: f32 kernel disagrees with plain: {errs[0]}")
    check(ratio <= 1.0, f"{what}: bf16 kernel off by more than one bf16 rounding: {errs}")
    check(same, f"{what}: a second launch gave other bits")
    return errs + (same,)


def kernel_vs_plain(got32, got16, want, what):
    """The tolerances of every kernel check: f32 atol/rtol 1e-3; bf16
    atol/rtol 0.05 with mean error < 0.01 (the JAX kernel tests'). Returns
    (max f32 error, max bf16 error, mean bf16 error)."""
    import torch
    e16 = (got16.float() - want).abs()
    errs = ((got32 - want).abs().max().item(), e16.max().item(), e16.mean().item())
    check(torch.allclose(got32, want, atol=1e-3, rtol=1e-3),
          f"{what}: f32 kernel disagrees with plain: {errs[0]}")
    check(torch.allclose(got16.float(), want, atol=0.05, rtol=0.05) and errs[2] < 0.01,
          f"{what}: bf16 kernel disagrees with plain: {errs[1:]}")
    return errs


def stem_phase(dev):
    """Phase 6: the stem kernel against its plain version for N, S and M
    weights (nonzero random biases) at bs2@640 and 2x66x130 (odd H/2 and
    W/2; 390-byte rows, which no 16-byte copy covers). Returns the largest
    bf16 error."""
    from mafyolo_tpu_torch.models.graph import parse_graph
    from mafyolo_tpu_torch.models.zoo import MODEL_ZOO

    from mafyolo_tpu_torch.ops import stem as S
    from mafyolo_tpu_torch.utils.bridge import random_folded_variables
    from mafyolo_tpu_torch.utils.sample import evaler, images
    worst = 0.0
    for name in ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m"):
        folded = random_folded_variables(parse_graph(MODEL_ZOO[name], nc=NC)[0], seed=1)
        sw = S.stem_build(evaler(name, folded, False, dev).model.net)
        for b, h, w in ((2, IMG, IMG), (2, 66, 130)):
            x = images(3, b, h, w).to(dev)
            e32, e16, m16, ratio, same = stem_gate(x, sw, f"stem {name} {h}x{w}")
            want = S.stem_plain(x, sw)
            emit(phase="stem_check", model=name, shape=[b, h, w], cout=sw.cout,
                 max_abs_err_f32=e32, max_abs_err_bf16=e16, mean_abs_err_bf16=m16,
                 bf16_err_over_one_rounding=ratio, bit_identical=same,
                 out_std=want.std().item(), positive_share=(want > 0).float().mean().item())
            worst = max(worst, e16)
    return worst


def neck_inputs(model, run):
    """(cfg, [x18, x4, x17u]) of one forward of a deploy model: the three
    channel blocks of layer 20's input (the Concat of row 19), NHWC."""
    from mafyolo_tpu_torch.ops import neck as N
    cap = []
    hook = model.net.layer20.register_forward_pre_hook(lambda m, a: cap.append(a[0]))
    run()
    hook.remove()
    cfg = N.neck80_cfg(model.specs, cap[0].shape[2])
    return cfg, [t.contiguous() for t in cap[0].permute(0, 2, 3, 1).split(list(cfg.cins), -1)]


def model_neck(model):
    """The model's own layers 19-22 as a function of (x18, x4, x17u) NHWC."""
    import torch
    net = model.net

    def run(x18, x4, x17u):
        xs = [t.permute(0, 3, 1, 2) for t in (x18, x4, x17u)]
        y20 = net.layer20(torch.cat(xs, 1))
        return y20, net.layer22(torch.cat([y20, xs[2]], 1))
    return run


def neck_phase(tag, model, xs, nw):
    """The neck kernel (bf16 and f32) against its plain version on sources
    xs; the plain version against the model's own layers 19-22 in f32.
    Returns the largest bf16 error."""
    import copy

    import torch

    from mafyolo_tpu_torch.ops import neck as N
    want = N.neck80_plain(*xs, nw)
    got32 = N.neck80_forward(*(x.float() for x in xs), nw, torch.float32)
    got16 = N.neck80_forward(*(x.bfloat16() for x in xs), nw, torch.bfloat16)
    m32 = copy.deepcopy(model).float()
    own = model_neck(m32)(*(x.float() for x in xs))
    rec = {"phase": "neck_check", "case": tag, "sources": [list(x.shape) for x in xs],
           "source_dtype": str(xs[0].dtype)}
    worst = 0.0
    for name, g32, g16, w, o in zip(("y20", "y22"), got32, got16, want, own):
        e32, e16, m16 = kernel_vs_plain(g32, g16, w, f"neck {tag} {name}")
        e_own = (o.permute(0, 2, 3, 1) - w).abs().max().item()
        check(torch.allclose(o.permute(0, 2, 3, 1), w, atol=1e-3, rtol=1e-3),
              f"neck {tag} {name}: plain differs from the model's own layers: {e_own}")
        rec.update({f"{name}_max_abs_err_f32": e32, f"{name}_max_abs_err_bf16": e16,
                    f"{name}_mean_abs_err_bf16": m16, f"{name}_plain_vs_model_layers": e_own,
                    f"{name}_std": w.std().item()})
        worst = max(worst, e16)
    emit(**rec)
    return worst


def route_timing(predict, batches):
    """(img/s, mean batch ms, p50, p90) of predict over batches on the card."""
    import numpy as np
    import torch

    from mafyolo_tpu_torch.utils.timing import cuda_ms
    mean_ms = cuda_ms(lambda: predict(batches[0]), iters=len(batches))
    lat = []
    for bt in batches:
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_.record()
        predict(bt)
        e_.record()
        torch.cuda.synchronize()
        lat.append(s_.elapsed_time(e_))
    return (batches[0].shape[0] / (mean_ms / 1e3), mean_ms, float(np.median(lat)),
            float(np.percentile(lat, 90)))


GRAPH_BATCHES = 2          # a serving path's batches held graph against eager
GRAPH_TIMED = 6            # and those each route is timed and profiled over
GRAPH_RAGGED = (2, 126, 94)  # no multiple of 4: the model's own layers 0-2
# the names of the kernels (as the profiler gives them) that each launch
# counter of core/graphs.py:COUNTERS counts: a greedy_nms launch is its
# bit-matrix kernel then its scan kernel
COUNTED_KERNELS = {"frontend_forward.launches": ("frontend_kernel<", "frontend_mma_kernel<"),
                   "greedy_nms.launches": ("nms_scan_kernel",),
                   "int8_conv.launches": ("int8_conv_kernel<", "conv3x3_kernel<"),
                   "int8_conv.launches_3x3": ("conv3x3_kernel<",),
                   "int8_dw.launches": ("int8_dw_kernel<",),
                   "dw_conv.launches": ("dw_conv_kernel<",)}
GRAPH_RATES = {}           # path -> graphs_check's times of both routes


def graph_times(path):
    """(img/s, mean, p50, p90 batch ms) of the graph route, as graphs_check
    timed it for path."""
    r = GRAPH_RATES[path]["graph"]
    return r["img_per_s"], r["batch_ms_mean"], r["p50_batch_ms"], r["p90_batch_ms"]


def graphs_check(path, card, graphs, predict, eager, batches, conf_over):
    """The `graphs` line of one serving path: predict(x, **static) replays
    the CUDA graphs of `graphs` (a core/graphs.py PredictGraphs), eager(x,
    **static) is the same predict by eager launches, static being conf_thres
    and multi_label. Bits: on GRAPH_BATCHES of batches, on the first at
    conf_over (its dense stage replayed: the key's flag set), with
    multi_label=False, and on a GRAPH_RAGGED batch, the graph's boxes,
    scores, classes and valid equal the eager ones bit for bit, and a second
    run of every key, made in the reverse order (so that keys replay out
    of their capture order on their shared pool), equals the first;
    counts: every launch counter moves alike over the eager run and each
    graph run, and over the profiled run of each route the kernels that the
    profiler saw (COUNTED_KERNELS) number as many as each counter moved.
    Times over GRAPH_TIMED batches (the path's, in turn), each route:
    img/s, mean, p50 and p90 batch ms by CUDA events, device busy ms a
    batch and idle share under the profiler; each key's warm-up and
    capture ms and the bytes its pool grew by. Returns the times, which it
    also keeps in GRAPH_RATES[path]."""
    from itertools import accumulate

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from mafyolo_tpu_torch.core.graphs import COUNTERS
    from mafyolo_tpu_torch.utils.sample import images

    def counts():
        return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in COUNTERS}

    ragged = images(8, *GRAPH_RAGGED).to(batches[0].device)
    calls = [(bt, {}) for bt in batches[:GRAPH_BATCHES]] + [
        (batches[0], {"conf_thres": conf_over}), (batches[0], {"multi_label": False}),
        (ragged, {})]

    def run(fn, order=1):
        before = counts()
        outs = [fn(x, **kw) for x, kw in calls[::order]][::order]
        torch.cuda.synchronize()
        return outs, {k: v - before[k] for k, v in counts().items()}

    g_outs, g_counts = run(predict)          # captures each key, then replays it
    e_outs, e_counts = run(eager)
    g2_outs, g2_counts = run(predict, -1)    # replays only, the last key first
    differ = [(i, k) for i, (g, e) in enumerate(zip(g_outs, e_outs)) for k in e
              if not torch.equal(g[k], e[k])]
    differ2 = [(i, k) for i, (g, g2) in enumerate(zip(g_outs, g2_outs)) for k in g
               if not torch.equal(g[k], g2[k])]
    over_keys = [kg.overflowed for key, kg in graphs.keys.items()
                 if ("conf_thres", conf_over) in key]
    rate, wall, launched, timed = {}, {}, {}, (batches * GRAPH_TIMED)[:GRAPH_TIMED]
    for route, fn in (("graph", predict), ("eager", eager)):
        img_s, mean_ms, p50, p90 = route_timing(fn, timed)
        rate[route] = {"img_per_s": img_s, "batch_ms_mean": mean_ms, "p50_batch_ms": p50,
                       "p90_batch_ms": p90}
    # one profiler session for both routes (its set-up costs seconds): the
    # routes' device spans split at the pause between them. A warm-up step
    # of each route comes first, traced and dropped: the records of the
    # first kernels after the tracer starts may be lost. Each route starts
    # a pause after the step's boundary too: a graph replay's first kernel
    # launched at once after it was once left out of the active step
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        predict(timed[0])
        eager(timed[0])
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.05)
        for route, fn in (("graph", predict), ("eager", eager)):
            before = counts()
            t0 = time.perf_counter()
            for bt in timed:
                fn(bt)
            torch.cuda.synchronize()
            wall[route] = (time.perf_counter() - t0) * 1e3
            launched[route] = {k: v - before[k] for k, v in counts().items()}
            time.sleep(0.05)
    _, spans, _ = device_busy(prof)
    ends = list(accumulate((e for _, e, _ in spans), max))
    cut = max(range(len(spans) - 1), key=lambda i: spans[i + 1][0] - ends[i]) + 1
    n, by_route, seen = len(timed), {}, {}
    for route, part in (("graph", spans[:cut]), ("eager", spans[cut:])):
        busy_us, _, by_route[route] = span_union(part)
        seen[route] = {k: sum(any(s in name for s in subs) for _, _, name in part)
                       for k, subs in COUNTED_KERNELS.items()}
        rate[route].update(profiled_batch_ms=wall[route] / n, device_busy_ms=busy_us / 1e3 / n,
                           idle_share=1 - busy_us / 1e3 / wall[route],
                           device_ops_per_batch=len(part) / n)
    # where the two routes' device time differs, by kernel name (us a batch)
    names = set(by_route["graph"]) | set(by_route["eager"])
    busy_diff = sorted(((by_route["graph"].get(k, 0.0) - by_route["eager"].get(k, 0.0)) / n,
                        k[:90]) for k in names)
    keys = [{"shape": list(key[0]), **dict(key[2:]), "warmup_ms": kg.warmup_ms,
             "capture_ms": kg.capture_ms, "pool_bytes": kg.pool_bytes,
             "overflow": kg.overflowed} for key, kg in graphs.keys.items()]
    emit(phase="graphs", path=path, card=card, batch=batches[0].shape[0],
         img=list(batches[0].shape[1:3]), bit_checks=len(calls) * 2, differ=differ,
         second_replay_differ=differ2, launches_graph=g_counts, launches_eager=e_counts,
         launches_graph_replay=g2_counts, overflow_key_flag=over_keys,
         profiled_launches_counted=launched, profiled_kernels_seen=seen, predict=rate,
         busy_us_graph_minus_eager=busy_diff[:3] + busy_diff[-5:], keys=keys)
    check(not differ, f"{path}: graph detections differ from eager at {differ[:4]}")
    check(not differ2, f"{path}: a second replay differs from the first at {differ2[:4]}")
    check(g_counts == e_counts == g2_counts,
          f"{path}: launches by graph {g_counts}, eager {e_counts}, replay {g2_counts}")
    check(over_keys == [True], f"{path}: the overflow batch's key flags {over_keys}")
    check(rate["graph"]["device_busy_ms"] > 0 and rate["eager"]["device_busy_ms"] > 0,
          f"{path}: the profiler saw no device activity")
    check(seen == launched and launched["graph"] == launched["eager"],
          f"{path}: the profiler saw kernels {seen}, the counters moved {launched}")
    GRAPH_RATES[path] = rate
    return rate


def evaler_routes(ev):
    """(graph, eager) predicts of an Evaler that take conf_thres and
    multi_label per call, as graphs_check calls them."""
    def with_conf(fn):
        def run(x, conf_thres=None, multi_label=True):
            keep = ev.conf_thres
            ev.conf_thres = keep if conf_thres is None else conf_thres
            try:
                return fn(x, multi_label=multi_label)
            finally:
                ev.conf_thres = keep
        return run
    return with_conf(ev.predict), with_conf(ev.predict_eager)


def main():
    import torch
    torch.set_grad_enabled(False)
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false); "
             "this script drives the port on an NVIDIA card")
    if not os.path.isdir(os.path.join(HERE, "mafyolo_tpu_torch")):
        fail("mafyolo_tpu_torch/ not found beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, HERE)
    import numpy as np

    from mafyolo_tpu_torch.models.graph import parse_graph
    from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
    from mafyolo_tpu_torch.ops import _build
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops import neck as N
    from mafyolo_tpu_torch.ops import stem as S
    from mafyolo_tpu_torch.ops.nms import fused_decode_nms
    from mafyolo_tpu_torch.utils import nms_cases as CASES
    from mafyolo_tpu_torch.utils.bridge import random_folded_variables
    from mafyolo_tpu_torch.utils.sample import (capture_nms_inputs, evaler, images,
                                                random_boxes, random_deploy)
    from mafyolo_tpu_torch.utils.timing import cuda_ms, graph_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build: one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    names = ("frontend", "greedy_nms", "dw_grad", "stem", "neck80", "fma_probe", "int8_conv",
             "int8_dw", "dw_conv")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    for name in names:
        secs, log = _build.BUILD_LOG.get(name, (time.perf_counter() - t0, ""))
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "Used " in ln or "spill" in ln]
        emit(phase="build", kernel=name, seconds=secs,
             lib=os.path.relpath(paths[name], HERE), ptxas=ptxas)
    tensor_core_check(paths)

    # ---- 3. front-end kernel vs plain
    fe_err, fe_w = {}, {}
    for name, b, (h, w) in (("maf-yolo-n", 4, (IMG, IMG)), ("maf-yolo-s", 2, (IMG, IMG)),
                            ("maf-yolo-m", 2, (IMG, IMG)), ("maf-yolo-n", 2, (256, 64)),
                            ("maf-yolo-n", 2, (200, 168)), ("maf-yolo-s", 2, (200, 168)),
                            ("maf-yolo-m", 2, (200, 168))):
        if name not in fe_w:
            specs = parse_graph(MODEL_ZOO[name], nc=NC)[0]
            fe_w[name] = evaler(name, random_folded_variables(specs, seed=1), False,
                                dev).fe_weights
        fw = fe_w[name]
        x = images(2, b, h, w).to(dev)
        want = FE.frontend_plain(x, fw)
        e32, e16, m16 = kernel_vs_plain(FE.frontend_forward(x, fw, torch.float32),
                                        FE.frontend_forward(x, fw, torch.bfloat16), want,
                                        f"frontend {name} {h}x{w}")
        plan16, plan32 = FE.frontend_plan(fw), FE.frontend_plan(fw, torch.float32)
        check((h, w) != (200, 168) or ((h // 4) % plan16[0] and (w // 4) % plan16[1]),
              f"the bf16 tile {plan16[:2]} divides {h // 4} x {w // 4}")
        emit(phase="frontend_check", model=name, shape=[b, h, w],
             bf16_plan=dict(zip(("tile_h", "tile_w", "smem_bytes", "threads"), plan16)),
             f32_plan=dict(zip(("tile_h", "tile_w", "smem_bytes", "threads"), plan32)),
             max_abs_err_f32=e32, max_abs_err_bf16=e16,
             mean_abs_err_bf16=m16, out_std=want.std().item())
        fe_err[name] = max(fe_err.get(name, 0.0), e16)
    del fe_w

    # ---- 4. NMS kernel vs plain: the two timing inputs at B = 32, then M
    # around the 64-box word at B = 8 and the named corner cases
    rng = np.random.default_rng(3)
    nms_inputs, nms_err = {}, 0.0     # the largest |keep - plain keep| over every gate

    def nms_gate(tag, bt, vt, thr):
        nonlocal nms_err
        got, want = G.greedy_nms(bt, vt, thr), G.greedy_nms_plain(bt, vt, thr)
        mismatch = int((got != want).sum().item())
        nms_err = max(nms_err, (got.float() - want.float()).abs().max().item())
        emit(phase="nms_check", case=tag, m=bt.shape[1], batch=bt.shape[0],
             kept=int(want.sum().item()), valid=int(vt.sum().item()), mismatches=mismatch)
        check(mismatch == 0, f"greedy_nms kernel keep set differs at {tag}: {mismatch}")
        return got

    for m in (512, 2000):
        boxes, valid = random_boxes(rng, BATCH, m)
        bt, vt = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
        nms_gate(f"random M={m}", bt, vt, 0.65)
        nms_inputs[m] = (bt, vt)
    for m in CASES.SIZES:
        boxes, valid = CASES.random_boxes(m, 8, m)
        nms_gate(f"dense M={m}", torch.from_numpy(boxes).to(dev),
                 torch.from_numpy(valid).to(dev), 0.65)
    for case in CASES.CORNER_CASES:
        boxes, valid, thr = CASES.corner_case(case)
        got = nms_gate(case, torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev), thr)
        check(CASES.expected(case, got.cpu().numpy()), f"greedy_nms kernel: wrong keep set at {case}")

    # ---- 5. dw_grad kernel vs plain
    dk_err = dw_grad_phase(dev)

    # ---- 6. stem kernel vs plain
    stem_err = stem_phase(dev)

    # ---- 7. slice (random_deploy: heads recentred for about 150 pairs per
    # image above conf 0.03)
    folded, thr_over = random_deploy("maf-yolo-n", dev)
    ev = evaler("maf-yolo-n", folded, True, dev)
    batches = [images(100 + i, BATCH).to(dev) for i in range(BATCHES)]
    pairs = torch.stack([sum((o[1] > 0.03).sum((1, 2, 3)) for o in ev.forward(bt))
                         for bt in batches[:2]]).flatten().cpu().numpy()
    pairs_over = sum((o[1] > thr_over).sum((1, 2, 3))
                     for o in ev.forward(batches[0])).cpu().numpy()
    emit(phase="slice_setup", pairs_per_image_min=int(pairs.min()),
         pairs_per_image_mean=float(pairs.mean()), pairs_per_image_max=int(pairs.max()),
         overflow_conf=thr_over, overflow_pairs_max=int(pairs_over.max()))
    check(pairs_over.max() > 512, "overflow batch does not overflow compact_k")
    torch.cuda.synchronize()

    FE.frontend_forward.launches = 0
    G.greedy_nms.launches = 0
    DD.dw_conv.launches = 0
    outs, nms_per_batch = [], []
    for bt in batches:
        before = G.greedy_nms.launches
        outs.append(ev.predict(bt))
        nms_per_batch.append(G.greedy_nms.launches - before)
    nms_before = G.greedy_nms.launches
    ev.conf_thres = thr_over          # one batch through the dense fallback
    over = ev.predict(batches[0])
    ev.conf_thres = 0.03
    torch.cuda.synchronize()
    launches = {"frontend": FE.frontend_forward.launches, "greedy_nms": G.greedy_nms.launches,
                "dw_conv": DD.dw_conv.launches}
    fast = sum(n == 1 for n in nms_per_batch)
    emit(phase="slice_run", batches=BATCHES + 1, launches=launches,
         fast_path_batches=fast, overflow_nms_launches=launches["greedy_nms"] - nms_before,
         dets_per_image_mean=float(torch.cat([o["valid"].sum(1) for o in outs]).float()
                                   .mean().item()),
         overflow_dets_per_image_mean=float(over["valid"].sum(1).float().mean().item()))
    check(launches["frontend"] == BATCHES + 1, f"front-end kernel launches {launches}")
    check(launches["dw_conv"] == 15 * (BATCHES + 1), f"deploy depthwise launches {launches}")
    check(launches["greedy_nms"] > 0 and fast > 0, f"NMS kernel launches {launches}")
    check(launches["greedy_nms"] - nms_before == 1 + -(-2000 // 256),
          "overflow batch did not take the fast stage's NMS, then the dense path's blocked NMS")
    check_dets(outs + [over], BATCH, "slice")

    # card f32 vs CPU plain versions, 2 images @640, and one 2x126x94 batch:
    # no multiple of 4, so it takes the model's own layers 0-2 (no front-end
    # launch). It has 252 anchors against 8400, so both sides predict it at
    # conf 0.001 (the COCO eval threshold) and every valid detection counts.
    gpu32, cpu32 = evaler("maf-yolo-n", folded, False, dev), evaler("maf-yolo-n", folded,
                                                                    False, "cpu")
    two = images(7, 2)
    n_ref, matched = match(cpu32.predict(two),
                           {k: v.cpu() for k, v in gpu32.predict(two.to(dev)).items()}, 0.1)
    # bf16 against f32 on the same bs32 batch: the front-end route
    # (Evaler.predict) and the stem route
    shares = {"n_frontend": bf16_vs_f32("maf-yolo-n frontend", gpu32.predict(batches[0]),
                                        outs[0], gpu32.forward(batches[0]),
                                        ev.forward(batches[0]))["share"]}
    n_stem, n_sw, n_stem_predict = stem_route("maf-yolo-n", folded, True, dev)
    shares["n_stem"] = bf16_vs_f32(
        "maf-yolo-n stem", gpu32.predict(batches[0]), n_stem_predict(batches[0]),
        gpu32.forward(batches[0]),
        n_stem(S.stem_conv_s2(batches[0], n_sw, torch.bfloat16)))["share"]
    del n_stem, n_sw, n_stem_predict
    ragged = images(8, 2, 126, 94)
    gpu32.conf_thres = cpu32.conf_thres = 0.001
    fe_before = FE.frontend_forward.launches
    got_r = {k: v.cpu() for k, v in gpu32.predict(ragged.to(dev)).items()}
    torch.cuda.synchronize()
    fe_ragged = FE.frontend_forward.launches - fe_before
    check_dets([got_r], 2, "slice ragged 126x94")
    n_ref_r, matched_r = match(cpu32.predict(ragged), got_r, 0.0)
    emit(phase="slice_check", cpu_dets_above_0p1=n_ref, matched=matched,
         fraction=matched / max(n_ref, 1), ragged_shape=[2, 126, 94],
         ragged_frontend_launches=fe_ragged, ragged_cpu_dets=n_ref_r,
         ragged_matched=matched_r, ragged_fraction=matched_r / max(n_ref_r, 1))
    check(n_ref >= 10 and matched / n_ref >= 0.95,
          f"card vs CPU: {matched}/{n_ref} detections matched")
    check(fe_ragged == 0, f"the 126x94 batch launched the front-end kernel {fe_ragged} times")
    check(n_ref_r >= 1 and matched_r / n_ref_r >= 0.95,
          f"126x94 card vs CPU: {matched_r}/{n_ref_r} detections matched")
    graphs_check("maf-yolo-n bf16", card, ev.graphs, *evaler_routes(ev), batches, thr_over)

    # ---- 8. neck kernel on N's real layer-20 input at bs32@640
    cfg_n, xs_n = neck_inputs(ev.model, lambda: ev.forward(batches[0]))
    nw_n = N.neck80_build(ev.model.net, cfg_n)
    neck_phase("maf-yolo-n bs32@640", ev.model, xs_n, nw_n)

    # ---- 9. timings (CUDA events, after warm-up)
    x = batches[0]
    img_s, e2e_ms, p50, p90 = graph_times("maf-yolo-n bf16")
    y = FE.frontend_forward(x, ev.fe_weights, torch.bfloat16)
    heads = ev.model(y)
    stage = {
        "frontend_ms": cuda_ms(lambda: FE.frontend_forward(x, ev.fe_weights, torch.bfloat16), 10),
        "layers3_33_ms": cuda_ms(lambda: ev.model(y), 10),
        "decode_nms_ms": cuda_ms(lambda: fused_decode_nms(heads), 10),
    }
    emit(phase="timing_e2e", model="maf-yolo-n", dtype="bf16", batch=BATCH, img=IMG,
         img_per_s=img_s, batch_ms_mean=e2e_ms, p50_batch_ms=p50, p90_batch_ms=p90, **stage)
    emit(phase="timing_decode_nms", model="maf-yolo-n", batch=BATCH, **decode_nms_split(heads))
    # the front-end kernel for N, S and M beside its plain version and the
    # deploy model's own layers 0-2 in bf16 (the library path it has to beat)
    fe = {}
    for name in ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m"):
        e = ev if name == "maf-yolo-n" else evaler(
            name, random_folded_variables(parse_graph(MODEL_ZOO[name], nc=NC)[0], seed=1),
            True, dev)
        own = model_layers0_2(e.model, torch.bfloat16)
        fe[name] = {
            "frontend_ms": cuda_ms(lambda: FE.frontend_forward(x, e.fe_weights, torch.bfloat16), 10),
            "frontend_f32_ms": cuda_ms(lambda: FE.frontend_forward(x, e.fe_weights), 5),
            "frontend_plain_ms": cuda_ms(
                lambda: FE.frontend_plain(x, e.fe_weights, torch.bfloat16), 5),
            "model_layers0_2_ms": cuda_ms(lambda: own(x), 10),
            **frontend_bound(e.fe_weights.cfg, BATCH, IMG, IMG)}
        del e, own
    fe_n = fe["maf-yolo-n"]
    nms_ms, nms_device_ms, nms_plain_ms = {}, {}, {}
    for m, (bt, vt) in nms_inputs.items():
        nms_ms[m] = cuda_ms(lambda: G.greedy_nms(bt, vt, 0.65), 10)
        nms_device_ms[m] = graph_ms(lambda: G.greedy_nms(bt, vt, 0.65))
        nms_plain_ms[m] = cuda_ms(lambda: G.greedy_nms_plain(bt, vt, 0.65), 3)
    # the same on the candidates of one real predict (the random boxes above
    # keep nearly everything; a predict keeps a minority of its valid boxes)
    bp, vp, thr_p = capture_nms_inputs(lambda: ev.predict_eager(x))[0]
    nms_predict = {"m": bp.shape[1], "valid": int(vp.sum().item()),
                   "kept": int(G.greedy_nms(bp, vp, thr_p).sum().item()),
                   "ms": cuda_ms(lambda: G.greedy_nms(bp, vp, thr_p), 10),
                   "device_ms": graph_ms(lambda: G.greedy_nms(bp, vp, thr_p)),
                   "plain_ms": cuda_ms(lambda: G.greedy_nms_plain(bp, vp, thr_p), 3)}
    # greedy NMS at M = 512. Bytes and operations: boxes, valid and keep moved
    # once; every kept box is held against every later box (about 16 f32
    # operations a pair). The walk itself is a chain of M dependent decisions
    # that no parallelism shortens: at one shared-memory round trip a
    # decision (about 33 clocks at 1.755 GHz) that is the latency floor.
    bt, vt = nms_inputs[512]
    kept = G.greedy_nms(bt, vt, 0.65)
    later = torch.arange(511, -1, -1, device=dev)
    nms_bound = bound(bt.numel() * 4 + 2 * vt.numel(),
                      16 * int((kept * later).sum().item()), "f32")
    nms_bound["latency_floor_ms"] = 512 * SMEM_ROUND_TRIP_CLOCKS / SM_CLOCK_HZ * 1e3
    emit(phase="timing_kernels", frontend_shape=[BATCH, IMG, IMG, 3], frontend=fe,
         nms_ms=nms_ms, nms_device_ms=nms_device_ms, nms_plain_ms=nms_plain_ms,
         nms_predict=nms_predict, nms_bound=nms_bound,
         note="nms_ms: CUDA events around eager calls; nms_device_ms: the same calls "
              "replayed from a CUDA graph, the host out of the way")

    del gpu32, cpu32, outs
    s_res = s_phases(dev, ev.model, xs_n, nw_n, card)
    shares.update(s_res["shares"])
    m_model = m_phase(dev, shares, card)
    emit(phase="bf16_vs_f32_shares", shares=shares, floors=BF16_SHARE_FLOOR,
         note="matched share of the f32 predict's detections (score > 0.1) by the bf16 "
              "predict of the same bs32 batch")
    for key, floor in BF16_SHARE_FLOOR.items():
        check(shares[key] >= floor, f"bf16 against f32, {key}: share {shares[key]} < {floor}")
    stem_t = stem_timing(dev, {"maf-yolo-n": ev.model, "maf-yolo-s": s_res["model"],
                               "maf-yolo-m": m_model})
    stem_s = stem_t["maf-yolo-s"]
    dw_kernel = dw_timing(dev)
    stem_err = max([stem_err] + [r["max_abs_err_bf16"] for r in stem_t.values()])
    del ev, batches, xs_n, m_model, s_res["model"]
    torch.set_grad_enabled(True)
    train = train_phases(dev)
    dk_err = max(dk_err, train["dk_err"])
    torch.set_grad_enabled(False)
    eval_phase(dev, folded, card)
    torch.set_grad_enabled(True)
    trainer_phase(dev, card)
    torch.set_grad_enabled(False)
    quant_kernels = quant_phase(dev, folded, card, thr_over)
    torch.set_grad_enabled(True)
    sm = sm_train_phase(dev)
    dk_err = max(dk_err, sm["dk_err"])
    bridge_phase(dev)
    ddp_phase(dev, card)
    rec = recipes_phase(dev, card)
    torch.set_grad_enabled(False)
    office = office_phase(dev, card)
    xq = export_quant_phase(dev, card, folded)
    torch.set_grad_enabled(True)
    remat = remat_phase(dev, card)
    ov = overfit_phase(dev, card)

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "frontend", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/frontend.cu",
         "replaces": "mafyolo_tpu/ops/frontend_pallas.py:467",
         "launches": launches["frontend"] + rec["frontend"] + remat["frontend"]
         + ov["frontend"],
         "max_abs_err": fe_err["maf-yolo-n"],
         "ms": fe_n["frontend_ms"], "plain_ms": fe_n["frontend_plain_ms"],
         "bound_ms": fe_n["bound_ms"], "bound_by": fe_n["bound_by"],
         "library_ms": fe_n["model_layers0_2_ms"]},
        office["kernel"],
        {"name": "greedy_nms", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "mafyolo_tpu/ops/pallas_nms.py:60",
         "launches": launches["greedy_nms"] + rec["greedy_nms"] + office["launches"]["greedy_nms"]
         + xq["launches"]["greedy_nms"] + remat["greedy_nms"] + ov["greedy_nms"],
         "max_abs_err": nms_err,
         "ms": nms_ms[512], "plain_ms": nms_plain_ms[512],
         "bound_ms": nms_bound["bound_ms"], "bound_by": nms_bound["bound_by"],
         "library_ms": None},
        {"name": "dw_grad", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/dw_grad.cu",
         "replaces": "mafyolo_tpu/ops/dw_grad_pallas.py:143 and :47",
         "launches": train["launches"] + rec["dw_grad"] + remat["dw_grad"] + ov["dw_grad"],
         "max_abs_err": dk_err,
         "ms": train["dk_ms"], "plain_ms": train["dk_plain_ms"],
         "bound_ms": train["dk_bound"]["bound_ms"], "bound_by": train["dk_bound"]["bound_by"],
         "library_ms": train["dk_library_ms"]},
        {"name": "stem", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/stem.cu",
         "replaces": "mafyolo_tpu/ops/stem_pallas.py:99", "launches": s_res["stem_launches"],
         "max_abs_err": stem_err, "ms": stem_s["ms"], "plain_ms": stem_s["plain_ms"],
         "bound_ms": stem_s["bound_ms"], "bound_by": stem_s["bound_by"],
         "library_ms": stem_s["library_ms"]},
        *s_res["kernels"],
        *[dict(k, launches=k["launches"] + xq["launches"][k["name"]] + ov[k["name"]]
               - (xq["launches"]["int8_conv3x3"] if k["name"] == "int8_conv" else 0))
          for k in quant_kernels],
        xq["kernel3x3"],
        dict(dw_kernel, launches=launches["dw_conv"] + rec["dw_conv"] + remat["dw_conv"]
             + ov["dw_conv"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def s_phases(dev, n_model, xs_n, nw_n, card):
    """Phases 10-12: MAF-YOLO-S deploy through the stem route, the neck kernel
    on its activations, the S timings by both routes and the neck and FMA
    probe kernels' times (the neck also on N's sources xs_n, with N's weights
    nw_n). Returns the kernel-line entries of the neck and FMA-probe kernels,
    the stem route's stem launches, the bf16-against-f32 shares of both
    routes and the bf16 deploy model of S."""
    import numpy as np
    import torch

    from mafyolo_tpu_torch.models.graph import parse_graph
    from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import neck as N
    from mafyolo_tpu_torch.ops import stem as S
    from mafyolo_tpu_torch.ops.nms import fused_decode_nms
    from mafyolo_tpu_torch.tools import profile_fma as P
    from mafyolo_tpu_torch.utils.bridge import random_folded_variables
    from mafyolo_tpu_torch.utils.sample import evaler, images, random_deploy
    from mafyolo_tpu_torch.utils.timing import cuda_ms
    bf16 = torch.bfloat16

    # ---- 10. slice_s: stem -> layers 1-33 -> decode + NMS, bf16, bs32@640,
    # with the neck kernel run on each batch's layer-20 input
    name = "maf-yolo-s"
    folded, s_over = random_deploy(name, dev)
    model, sw, predict = stem_route(name, folded, True, dev)
    batches = [images(300 + i, BATCH).to(dev) for i in range(BATCHES)]
    cfg, xs = neck_inputs(model, lambda: S.stem_apply(model, sw, batches[0]))
    nw = N.neck80_build(model.net, cfg)

    def tap(mod, args):
        x = args[0].permute(0, 2, 3, 1)
        N.neck80_forward(*(t.contiguous() for t in x.split(list(cfg.cins), -1)), nw, x.dtype)

    torch.cuda.synchronize()
    S.stem_conv_s2.launches = N.neck80_forward.launches = G.greedy_nms.launches = 0
    FE.frontend_forward.launches = 0
    hook = model.net.layer20.register_forward_pre_hook(tap)
    outs = [predict(bt) for bt in batches]
    torch.cuda.synchronize()
    hook.remove()
    launches = {"stem": S.stem_conv_s2.launches, "neck80": N.neck80_forward.launches,
                "greedy_nms": G.greedy_nms.launches, "frontend": FE.frontend_forward.launches}
    emit(phase="slice_s", model=name, dtype="bf16", batch=BATCH, img=IMG, batches=BATCHES,
         launches=launches, dets_per_image_mean=float(
             torch.cat([o["valid"].sum(1) for o in outs]).float().mean().item()))
    check(launches["stem"] == BATCHES and launches["neck80"] == BATCHES
          and launches["greedy_nms"] > 0 and launches["frontend"] == 0,
          f"slice_s kernel launches {launches}")
    check_dets(outs, BATCH, "slice_s")

    # In f32 on the card: the stem route against the front-end route
    # (Evaler.predict) on one bs32 batch, and against the CPU plain path on 2
    # images. Then each bf16 route against the f32 predict of the same batch,
    # and where each leaves the f32 values: layer 0 (stem) and layer 2 (both).
    ev_s = evaler(name, folded, True, dev)
    ev_s32 = evaler(name, folded, False, dev)
    predict32 = stem_route(name, folded, False, dev)[2]
    ref32 = ev_s32.predict(batches[0])
    n_fe, m_fe = match(on_cpu(ref32), on_cpu(predict32(batches[0])), 0.1)
    two = images(9, 2)
    n_cpu, m_cpu = match(stem_route(name, folded, False, "cpu")[2](two),
                         on_cpu(predict32(two.to(dev))), 0.1)
    emit(phase="slice_s_check", f32_frontend_route_dets_above_0p1=n_fe, f32_matched=m_fe,
         f32_fraction=m_fe / max(n_fe, 1), cpu_f32_dets_above_0p1=n_cpu, cpu_matched=m_cpu,
         cpu_fraction=m_cpu / max(n_cpu, 1))
    check(n_fe >= 10 and m_fe / n_fe >= 0.95,
          f"slice_s vs the front-end route: {m_fe}/{n_fe} detections matched")
    check(n_cpu >= 10 and m_cpu / n_cpu >= 0.95,
          f"slice_s card f32 vs CPU: {m_cpu}/{n_cpu} detections matched")
    x = batches[0]
    heads32 = ev_s32.forward(x)
    shares = {"s_stem": bf16_vs_f32("maf-yolo-s stem", ref32, outs[0], heads32,
                                    model(S.stem_conv_s2(x, sw, bf16)))["share"],
              "s_frontend": bf16_vs_f32("maf-yolo-s frontend", ref32, ev_s.predict(x), heads32,
                                        ev_s.forward(x))["share"]}
    y2_32 = model_layers0_2(ev_s32.model, torch.float32)(x).permute(0, 2, 3, 1)
    y2_stem = model.net.layer2(model.net.layer1(
        S.stem_conv_s2(x, sw, bf16).permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    y0_32 = S.stem_plain(x, sw)
    emit(phase="bf16_first_layers", model=name, batch=BATCH,
         stem_layer0_vs_f32=rel_err(S.stem_conv_s2(x, sw, bf16), y0_32),
         stem_layer0_equal_to_rounded_f32=(S.stem_conv_s2(x, sw, bf16) == y0_32.to(bf16))
         .float().mean().item(),
         stem_route_layer2_vs_f32=rel_err(y2_stem, y2_32),
         frontend_layer2_vs_f32=rel_err(FE.frontend_forward(x, ev_s.fe_weights, bf16), y2_32),
         note="(max |bf16 - f32| / max |f32|, mean |bf16 - f32| / mean |f32|) on the same "
              "batch; f32 is stem_plain at layer 0 and the f32 model's own layers 0-2")
    del ev_s32, predict32, heads32, y0_32, y2_32, y2_stem
    graphs_check("maf-yolo-s bf16", card, ev_s.graphs, *evaler_routes(ev_s), batches, s_over)

    # ---- 11. neck on S's real sources at bs32, and on random M sources at bs2
    neck_err = neck_phase("maf-yolo-s bs32@640", model, xs, nw)
    specs_m = parse_graph(MODEL_ZOO["maf-yolo-m"], nc=NC)[0]
    m_model = evaler("maf-yolo-m", random_folded_variables(specs_m, seed=2), False, dev).model
    cfg_m = N.neck80_cfg(m_model.specs, IMG // 8)
    gen = torch.Generator(device=dev).manual_seed(5)
    neck_phase("maf-yolo-m bs2 random", m_model,
               [torch.randn((2, cfg_m.h, cfg_m.h, c), generator=gen, device=dev) * 0.5
                for c in cfg_m.cins], N.neck80_build(m_model.net, cfg_m))
    del m_model

    # ---- 12. timing_s: both routes, their stages, and the kernels
    x = batches[0]
    y0 = S.stem_conv_s2(x, sw, bf16)
    heads = model(y0)
    stem_img_s, stem_e2e, stem_p50, stem_p90 = route_timing(predict, batches)
    stem_stages = {"stem_ms": cuda_ms(lambda: S.stem_conv_s2(x, sw, bf16), 10),
                   "layers1_33_ms": cuda_ms(lambda: model(y0), 10),
                   "decode_nms_ms": cuda_ms(lambda: fused_decode_nms(heads), 10)}
    y2 = FE.frontend_forward(x, ev_s.fe_weights, bf16)
    heads2 = ev_s.model(y2)
    fe_img_s, fe_e2e, fe_p50, fe_p90 = graph_times("maf-yolo-s bf16")
    fe_stages = {"frontend_ms": cuda_ms(lambda: FE.frontend_forward(x, ev_s.fe_weights, bf16), 10),
                 "layers3_33_ms": cuda_ms(lambda: ev_s.model(y2), 10),
                 "decode_nms_ms": cuda_ms(lambda: fused_decode_nms(heads2), 10)}
    emit(phase="timing_s", model=name, dtype="bf16", batch=BATCH, img=IMG,
         stem_route={"img_per_s": stem_img_s, "batch_ms_mean": stem_e2e, "p50_batch_ms": stem_p50,
                     "p90_batch_ms": stem_p90, **stem_stages},
         frontend_route={"img_per_s": fe_img_s, "batch_ms_mean": fe_e2e, "p50_batch_ms": fe_p50,
                         "p90_batch_ms": fe_p90, **fe_stages})
    neck = {}
    for tag, mdl, srcs, w in (("maf-yolo-s", model, xs, nw), ("maf-yolo-n", n_model, xs_n, nw_n)):
        srcs32 = [t.float() for t in srcs]
        own = model_neck(mdl)
        neck[tag] = {"neck_ms": cuda_ms(lambda: N.neck80_forward(*srcs, w, bf16), 10),
                     "neck_f32_ms": cuda_ms(lambda: N.neck80_forward(*srcs32, w), 5),
                     "neck_plain_ms": cuda_ms(lambda: N.neck80_plain(*srcs, w), 5),
                     "model_layers19_22_ms": cuda_ms(lambda: own(*srcs), 10),
                     **neck_bound(w.cfg, BATCH)}
    x_f, w_f = P.operands(dev)
    P.fma_chain.launches = 0
    fma = P.measure(x_f, w_f)                    # the probe tool's own entry
    fma_launches = P.fma_chain.launches
    got, want = P.fma_chain(x_f, w_f).float(), P.fma_plain(x_f, w_f).float()
    fma_err = (got - want).abs().max().item()
    scale = (x_f.float().abs().max() * w_f.abs().sum()).item()
    check(torch.allclose(got, want, rtol=2 ** -7, atol=1e-5 * scale),
          f"fma_probe kernel disagrees with the plain f32 chain: {fma_err}")
    n_el = x_f.numel()
    fma_bound = bound(4 * n_el + 4 * P.TAPS, 2 * P.TAPS * n_el, "f32")
    emit(phase="timing_kernels_s", fma_bound=fma_bound, neck_batch=BATCH, neck_h=cfg.h, neck=neck,
         fma_shape=list(P.SHAPE), fma_max_abs_err=fma_err,
         fma_tolerance="rtol 2^-7, atol 1e-5 * max|x| * sum|w| (one bf16 rounding)",
         fma=[{"name": n, "ms": ms, "tflops": tf, "gb_per_s": gb} for n, ms, tf, gb in fma])
    check(fma_launches > 0, "the FMA probe's tool run launched no kernel")
    return {"stem_launches": launches["stem"], "shares": shares, "model": ev_s.model, "kernels": [
        {"name": "neck80", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/neck80.cu",
         "replaces": "mafyolo_tpu/ops/neck_pallas.py:259", "launches": launches["neck80"],
         "max_abs_err": neck_err, "ms": neck[name]["neck_ms"],
         "plain_ms": neck[name]["neck_plain_ms"], "bound_ms": neck[name]["bound_ms"],
         "bound_by": neck[name]["bound_by"],
         "library_ms": neck[name]["model_layers19_22_ms"]},
        {"name": "fma_probe", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/fma_probe.cu",
         "replaces": "tools/profile_vpu.py:51", "launches": fma_launches,
         "max_abs_err": fma_err, "ms": fma[2][1], "plain_ms": fma[0][1],
         "bound_ms": fma_bound["bound_ms"], "bound_by": fma_bound["bound_by"],
         "library_ms": None},
    ]}


def m_phase(dev, shares, card):
    """Phase 13: MAF-YOLO-M deploy served end to end through Evaler.predict,
    bf16, M_BATCHES batches of bs32 uint8 @640, with the front-end and NMS
    launch counts read around that run; card f32 against the CPU plain path
    on 2 images; bf16 against f32 on one batch (into `shares`); img/s, p50
    and the stage split. Returns the bf16 deploy model."""
    import torch

    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops.nms import fused_decode_nms
    from mafyolo_tpu_torch.utils.sample import evaler, images, random_deploy
    from mafyolo_tpu_torch.utils.timing import cuda_ms
    name = "maf-yolo-m"
    folded, m_over = random_deploy(name, dev)
    ev = evaler(name, folded, True, dev)
    batches = [images(500 + i, BATCH).to(dev) for i in range(M_BATCHES)]
    torch.cuda.synchronize()
    FE.frontend_forward.launches = G.greedy_nms.launches = 0
    outs = [ev.predict(bt) for bt in batches]
    torch.cuda.synchronize()
    launches = {"frontend": FE.frontend_forward.launches, "greedy_nms": G.greedy_nms.launches}
    emit(phase="slice_m", model=name, dtype="bf16", batch=BATCH, img=IMG, batches=M_BATCHES,
         launches=launches, dets_per_image_mean=float(
             torch.cat([o["valid"].sum(1) for o in outs]).float().mean().item()))
    check(launches["frontend"] == M_BATCHES and launches["greedy_nms"] > 0,
          f"slice_m kernel launches {launches}")
    check_dets(outs, BATCH, "slice_m")

    ev32 = evaler(name, folded, False, dev)
    two = images(12, 2)
    n_cpu, m_cpu = match(evaler(name, folded, False, "cpu").predict(two),
                         on_cpu(ev32.predict(two.to(dev))), 0.1)
    emit(phase="slice_m_check", cpu_f32_dets_above_0p1=n_cpu, cpu_matched=m_cpu,
         cpu_fraction=m_cpu / max(n_cpu, 1))
    check(n_cpu >= 10 and m_cpu / n_cpu >= 0.95,
          f"slice_m card f32 vs CPU: {m_cpu}/{n_cpu} detections matched")
    x = batches[0]
    shares["m_frontend"] = bf16_vs_f32("maf-yolo-m frontend", ev32.predict(x), outs[0],
                                       ev32.forward(x), ev.forward(x))["share"]
    del ev32
    graphs_check("maf-yolo-m bf16", card, ev.graphs, *evaler_routes(ev), batches, m_over)

    img_s, e2e, p50, p90 = graph_times("maf-yolo-m bf16")
    y = FE.frontend_forward(x, ev.fe_weights, torch.bfloat16)
    heads = ev.model(y)
    emit(phase="timing_m", model=name, dtype="bf16", batch=BATCH, img=IMG,
         img_per_s=img_s, batch_ms_mean=e2e, p50_batch_ms=p50, p90_batch_ms=p90,
         frontend_ms=cuda_ms(lambda: FE.frontend_forward(x, ev.fe_weights, torch.bfloat16), 10),
         layers3_33_ms=cuda_ms(lambda: ev.model(y), 10),
         decode_nms_ms=cuda_ms(lambda: fused_decode_nms(heads), 10))
    return ev.model


def stem_timing(dev, models):
    """Phase 14: the stem kernel at bs32@640 for each {name: bf16 deploy model}: its
    gates (stem_gate), then CUDA-event ms of the kernel (bf16 and f32), its
    plain version and the model's own layer 0 in bf16 (flip, cast and /255
    included), each call taking the next of enough copies of the input that
    none is found in the 50 MB L2 (the input is 39 MB), and the bound.
    Returns {name: record}."""
    import torch

    from mafyolo_tpu_torch.ops import stem as S
    from mafyolo_tpu_torch.utils.sample import cold_sets, images, in_turn
    from mafyolo_tpu_torch.utils.timing import cuda_ms
    bf16 = torch.bfloat16
    x = images(600, BATCH).to(dev)
    sets = cold_sets((x,))
    out = {}
    for name, model in models.items():
        sw = S.stem_build(model.net)
        e32, e16, m16, ratio, same = stem_gate(x, sw, f"stem {name} bs{BATCH}@{IMG}")
        layer0 = model.net.layer0
        c0 = sw.cout
        out[name] = {
            "ms": cuda_ms(in_turn(lambda x: S.stem_conv_s2(x, sw, bf16), sets), 20),
            "f32_ms": cuda_ms(in_turn(lambda x: S.stem_conv_s2(x, sw), sets), 10),
            "plain_ms": cuda_ms(in_turn(lambda x: S.stem_plain(x, sw, bf16), sets), 10),
            "library_ms": cuda_ms(in_turn(
                lambda x: layer0((x.flip(-1).to(bf16) / 255.0).permute(0, 3, 1, 2)), sets), 20),
            "max_abs_err_f32": e32, "max_abs_err_bf16": e16, "mean_abs_err_bf16": m16,
            "bf16_err_over_one_rounding": ratio, "bit_identical": same,
            **bound(x.numel() + BATCH * (IMG // 2) ** 2 * c0 * 2 + 28 * c0 * 4,
                    2 * 27 * c0 * BATCH * (IMG // 2) ** 2, "bf16")}
    emit(phase="timing_stem", shape=[BATCH, IMG, IMG, 3], input_sets=len(sets), stem=out,
         note="ms, f32_ms, plain_ms (bf16 out) and library_ms: CUDA events around eager "
              "calls on copies of the input taken in turn, none in L2")
    return out


def dw_timing(dev):
    """Phase 14, second part: the deploy depthwise kernel alone at every
    depthwise site of N's, S's and M's bf16 predict at bs32@640
    (tools/tune_kernels.py:time_dw_site: random weights, bias and inputs
    from a seed; cold, the inputs taken in turn, none in L2, from a CUDA
    graph): each within one
    bf16 rounding of its plain version's f32 result on the card, its ms
    beside cuDNN's bf16 conv with the bias and the site's activation
    (library_ms: what the graph ran before the kernel) and the bound, summed
    by class (k, side); then the plain version's ms on N's sites. Returns
    the kernels line's entry: N's 15 sites past the front-end, summed."""
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    from mafyolo_tpu_torch.tools.tune_kernels import (DW_GRAPHS, dw_deploy_inputs,
                                                      time_dw_site)
    from mafyolo_tpu_torch.utils.sample import deploy_dw_sites
    from mafyolo_tpu_torch.utils.timing import cuda_ms
    classes, n_sum, bad = {}, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                "bound_bytes": 0, "bound_flops": 0, "max_abs_err": 0.0}, []
    for name in DW_GRAPHS:
        for site, count, front in deploy_dw_sites(name, IMG, dev):
            x, wt, bias = dw_deploy_inputs(site, BATCH, dev)
            rec = time_dw_site(x, wt, bias, site[4])
            if not rec["within_rounding"]:
                bad.append((name, site))
            cls = classes.setdefault(f"{name} k{site[3]} {site[1]}px", {
                "sites": 0, "front_end": front, "ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0})
            cls["sites"] += count
            for key, src in (("ms", "cold_ms"), ("library_ms", "library_ms"),
                             ("bound_ms", "bound_ms")):
                cls[key] += count * rec[src]
            if name == "maf-yolo-n" and not front:
                n_sum["ms"] += count * rec["cold_ms"]
                n_sum["library_ms"] += count * rec["library_ms"]
                n_sum["bound_bytes"] += count * rec["bytes"]
                n_sum["bound_flops"] += count * rec["ops"]
                n_sum["max_abs_err"] = max(n_sum["max_abs_err"], rec["max_abs_err"])
                n_sum["plain_ms"] += count * cuda_ms(
                    lambda: DD.dw_conv_plain(x, wt, bias, site[4]), 3, warmup=1)
    for cls in classes.values():
        cls["bound_over_kernel"] = cls["bound_ms"] / cls["ms"]
    emit(phase="timing_dw", batch=BATCH, img=IMG, classes=classes, n_past_front_end=n_sum,
         outside_rounding=bad,
         note="ms (the kernel, bias and activation fused) and library_ms (cuDNN's conv, its "
              "bias add and the activation): device time of calls on copies of the input taken "
              "in turn, none in L2, replayed from a CUDA graph; sums over each class's sites")
    check(not bad, f"dw_conv kernel outside one bf16 rounding at {bad[:4]}")
    return {"name": "dw_conv", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/dw_conv.cu",
            "replaces": "none (XLA's conv, mafyolo_tpu/ops/dwconv.py; cuDNN on the card)",
            "max_abs_err": n_sum["max_abs_err"], "ms": n_sum["ms"], "plain_ms": n_sum["plain_ms"],
            **bound(n_sum["bound_bytes"], n_sum["bound_flops"], "bf16"),
            "library_ms": n_sum["library_ms"]}


def as_predict(preds, ids):
    """An eval loop's COCO-format detections of the images `ids` as a
    predict()-style dict of padded CPU tensors (xyxy native boxes), one row
    an image, in the loop's order."""
    import torch
    rows = {i: [] for i in ids}
    for d in preds:
        rows[d["image_id"]].append(d)
    k = max([1] + [len(r) for r in rows.values()])
    out = {"boxes": torch.zeros(len(ids), k, 4, dtype=torch.float64),
           "scores": torch.zeros(len(ids), k, dtype=torch.float64),
           "classes": torch.zeros(len(ids), k, dtype=torch.int64),
           "valid": torch.zeros(len(ids), k, dtype=torch.bool)}
    for r, i in enumerate(ids):
        for j, d in enumerate(rows[i]):
            x, y, w, h = d["bbox"]
            out["boxes"][r, j] = torch.tensor([x, y, x + w, y + h], dtype=torch.float64)
            out["scores"][r, j], out["classes"][r, j] = d["score"], d["category_id"]
            out["valid"][r, j] = True
    return out


def eval_phase(dev, folded, card):
    """Phase 19: MAF-YOLO-N (random_deploy weights `folded`) through the
    port's eval loop on the card: utils/sample.py:ArrayDataset (EVAL_SIZES
    images, long side IMG, 1-30 labelled rectangles each) -> letterbox ->
    DataLoader (8 threads) -> Evaler.predict_model -> COCOEvaluator, with
    the front-end and NMS launch counts read around it. Gates: 1. f32 card
    against the CPU on the first 4 images; 2. in f32, against labels made
    from the card's own f32 detections (score > 0.1, the best 100 of a
    class in an image: what COCOEvaluator's maxDets keeps), run_eval gives
    AP50 >= 0.99 and AP >= 0.95; 3. rect batches: one front-end launch a
    batch, and the kernel against its plain version at every shape met;
    4. bf16 run_eval AP50 and AP on gate 2's labels at least
    EVAL_BF16_AP_FLOOR; 5. the short last batch launches both kernels and
    every image of it has detections. Then the eval loop's img/s (bf16,
    rect=False, loader included), its speed_result split and the device's
    idle share over one more loop under the profiler, beside
    Evaler.predict alone on the same batches."""
    import numpy as np
    import torch

    from mafyolo_tpu_torch.core.evaler import Evaler, run_eval
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, eval_set, labels_from_detections
    sizes = [hw for hw, n in EVAL_SIZES.items() for _ in range(n)]
    sizes = [sizes[i] for i in np.random.default_rng(20).permutation(len(sizes))]
    src = eval_set(20, sizes)
    data = {"val": src, "nc": NC, "names": [str(c) for c in range(NC)]}
    kw = dict(img_size=IMG, batch_size=BATCH, workers=8, plot_curve=False,
              dataset_cls=ArrayDataset)

    def launches():
        return FE.frontend_forward.launches, G.greedy_nms.launches

    def loop(source, half, rect=False, device=dev, **extra):
        """(evaler, detections, [(batch shape, front-end launches, NMS
        launches, images)] a batch) of one eval loop over source."""
        ev = Evaler({**data, "val": source}, half=half, rect=rect, device=device,
                    **{**kw, **extra})
        loader = ev.init_data()
        ev.init_model("maf-yolo-n", folded, NC, folded=True)
        log = []

        def counted():
            for batch in loader:
                log.append((batch[0].shape, *launches(), batch[0]))
                yield batch
            log.append((None, *launches(), None))
        preds = ev.predict_model(counted())
        per = [(sh, fe1 - fe0, nms1 - nms0, im) for (sh, fe0, nms0, im), (_, fe1, nms1, _)
               in zip(log, log[1:])]
        return ev, preds, per

    torch.cuda.synchronize()
    FE.frontend_forward.launches = G.greedy_nms.launches = 0
    # gate 1: f32 card against the CPU plain versions, the first 4 images
    first4 = {"images": src["images"][:4], "labels": src["labels"][:4]}
    ev4, preds4, _ = loop(first4, False, batch_size=4)
    _, preds4_cpu, _ = loop(first4, False, batch_size=4, device="cpu")
    ids4 = [ev4.dataset.image_id(i) for i in range(4)]
    n_cpu, m_cpu = match(as_predict(preds4_cpu, ids4), as_predict(preds4, ids4), 0.1)
    check(n_cpu >= 10 and m_cpu / n_cpu >= 0.95,
          f"eval card f32 vs CPU: {m_cpu}/{n_cpu} detections matched")

    # gate 2 (with gate 5 on its short last batch): f32 labels from the
    # card's own f32 detections, then run_eval against them
    ev32, preds32, per32 = loop(src, False)
    src2 = {"images": src["images"], "labels": labels_from_detections(preds32, ev32.dataset)}
    n_labels = [len(lb) for lb in src2["labels"]]
    m32 = run_eval("maf-yolo-n", folded, NC, {**data, "val": src2}, folded=True, half=False,
                   device=dev, **kw)
    check(m32["AP50"] >= 0.99 and m32["AP"] >= 0.95,
          f"eval f32 against its own detections: AP50 {m32['AP50']}, AP {m32['AP']}")

    # gate 3: rect batches; the front-end kernel at every shape met
    evr, _, per_r = loop(src2, True, rect=True)
    check(all(fe == 1 and nms >= 1 for _, fe, nms, _ in per_r),
          f"rect eval launches a batch {[(s, fe, n) for s, fe, n, _ in per_r]}")
    rect_shapes = {}
    for sh, _, _, im in per_r:
        rect_shapes.setdefault(tuple(sh[1:3]), im)
    rect_err = {}
    fe_path = FE.frontend_forward.launches     # the checks' launches are not the path's
    for (h, w), im in rect_shapes.items():
        x = torch.from_numpy(im).to(dev)
        want = FE.frontend_plain(x, evr.fe_weights)
        rect_err[f"{h}x{w}"] = kernel_vs_plain(
            FE.frontend_forward(x, evr.fe_weights, torch.float32),
            FE.frontend_forward(x, evr.fe_weights, torch.bfloat16), want,
            f"eval rect frontend {h}x{w}")
    FE.frontend_forward.launches = fe_path
    check(len(rect_shapes) >= 2 and any(h != w for h, w in rect_shapes),
          f"rect eval met shapes {list(rect_shapes)}")

    # gate 4: bf16 against gate 2's labels
    m16 = run_eval("maf-yolo-n", folded, NC, {**data, "val": src2}, folded=True, half=True,
                   device=dev, **kw)
    torch.cuda.synchronize()
    path_launches = dict(zip(("frontend", "greedy_nms"), launches()))
    n_batches = 1 + 4 * -(-len(src["images"]) // BATCH)   # gate 1's, then four loops
    check(path_launches["frontend"] == n_batches and path_launches["greedy_nms"] >= n_batches,
          f"eval path launches {path_launches} over {n_batches} batches")
    for key, floor in EVAL_BF16_AP_FLOOR.items():
        check(m16[key] >= floor, f"eval bf16 {key} {m16[key]} < {floor}")

    # gate 5: the short last batch of the f32 loop
    last_shape, last_fe, last_nms, _ = per32[-1]
    last_ids = [ev32.dataset.image_id(i) for i in range(len(src["images"]) - last_shape[0],
                                                         len(src["images"]))]
    last_dets = [sum(d["image_id"] == i for d in preds32) for i in last_ids]
    check(last_shape[0] == len(src["images"]) % BATCH and last_fe == 1 and last_nms >= 1
          and min(last_dets) > 0,
          f"short last batch {last_shape}: launches {last_fe}, {last_nms}; dets {last_dets}")

    # the eval loop's speed, bf16 rect=False, loader included, beside
    # Evaler.predict alone on the same batches (numpy in, and already on the card)
    ev16 = Evaler({**data, "val": src2}, half=True, device=dev, **kw)
    loader = ev16.init_data()
    ev16.init_model("maf-yolo-n", folded, NC, folded=True)
    ev16.predict_model(loader)                          # warm-up
    loop_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        ev16.predict_model(loader)
        wall = time.perf_counter() - t0
        n, h2d, infer, post = ev16.speed_result
        loop_runs.append({"img_per_s": n / wall, "wall_ms": wall * 1e3, "per_image_ms": {
            "h2d": h2d / n, "infer_nms": infer / n, "post": post / n,
            "loader_and_rest": (wall * 1e3 - h2d - infer - post) / n}})
    # the device's busy time over one more loop under the profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev16.predict_model(loader)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_us, spans, _ = device_busy(prof)
    check(busy_us > 0, "eval: the profiler saw no device activity")
    profiled = {"wall_ms": prof_ms, "device_busy_ms": busy_us / 1e3,
                "idle_share": 1 - busy_us / 1e3 / prof_ms, "device_ops": len(spans)}
    batches = [b[0] for b in loader]
    on_card = [torch.from_numpy(b).to(dev) for b in batches]
    alone = {}
    for tag, bs in (("numpy_in", batches), ("on_card", on_card)):
        for b in bs:
            ev16.predict(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            ev16.predict(b)
        torch.cuda.synchronize()
        alone[tag] = len(src["images"]) / (time.perf_counter() - t0)
    emit(phase="eval", model="maf-yolo-n", card=card, images=len(src["images"]),
         sizes={f"{h}x{w}": n for (h, w), n in EVAL_SIZES.items()}, batch=BATCH, workers=8,
         launches=path_launches, batches_on_card=n_batches,
         gate1_cpu_f32_dets_above_0p1=n_cpu, gate1_matched=m_cpu,
         gate2_labels=sum(n_labels), gate2_labels_per_image=[min(n_labels), max(n_labels)],
         gate2_f32=m32,
         gate3_rect_batches=[[list(s), fe, nms] for s, fe, nms, _ in per_r],
         gate3_frontend_err={k: {"max_abs_err_f32": e[0], "max_abs_err_bf16": e[1],
                                 "mean_abs_err_bf16": e[2]} for k, e in rect_err.items()},
         gate4_bf16=m16, gate4_floor=EVAL_BF16_AP_FLOOR,
         gate5_last_batch=[list(last_shape), last_fe, last_nms, last_dets],
         loop_bf16=loop_runs, loop_profiled=profiled, predict_alone_img_per_s=alone,
         graph_captures=ev16.graphs.captures,
         graph_keys=[{"shape": list(key[0]), "warmup_ms": kg.warmup_ms,
                      "capture_ms": kg.capture_ms, "pool_bytes": kg.pool_bytes}
                     for key, kg in ev16.graphs.keys.items()],
         note="loop img/s: images over predict_model's wall time (loader, h2d, predict, "
              "post); per_image_ms from speed_result; loop_profiled: one more loop under "
              "torch.profiler, the union of the device's spans against its wall time; "
              "predict alone: the loop's batches through Evaler.predict, numpy in (h2d "
              "included) and already on the card")


def trainer_phase(dev, card):
    """Phase 20: MAF-YOLO-N trained through the port's Trainer on the card:
    --device-aug, configs/maf_yolo_n.py's solver and data_aug, bs BATCH @
    IMG in bf16, TRAIN_IMAGES images held in memory (utils/sample.py:
    train_set; batches of 32, 32 and 8) and the eval phase's 70 val images.
    Trainer A (epochs 4, no stop-aug tail) runs epochs 0-1 through
    train_one_epoch + eval_and_save; Trainer B resumes from A's
    last_ckpt.npck and train()s epochs 2-3 (3 is the first TAL epoch),
    evaluating at the last and stripping. Gates: 1. dw_grad launches 53 a
    step (short batch included), and each eval one front-end launch a batch
    and at least as many NMS launches; 2. device_augment of the first batch
    on the card against the same function on the CPU on the same draw:
    images within DEVICE_AUG_TOL, label counts equal, boxes within 1e-3 px;
    3. B's state after resume equal to A's at the end of epoch 1, bit for
    bit (params, BN stats, momentum, EMA, updates) and B.start_epoch 2; 4.
    every step's loss finite, parameters moved on every apply step and on
    no other (in warm-up the weight lr is 0 to 4e-6, below the f32 step of
    most kernels: the biases, at lr 0.1, move); 5.
    last_ckpt.npck each epoch and best_ckpt.npck exactly when an eval
    beat the best AP before it (the JAX rule); after strip_models no opt,
    no EMA and fp16 model leaves, and the stripped checkpoint evaluates
    through load_checkpoint -> eval_variables -> run_eval. Then A runs
    epoch 2 under the profiler (the device's idle share) and epoch 3 timed
    (img/s, loader and device aug included); device_augment's and the
    step's ms by CUDA events; whether B's EMA gives a box above conf 0.03
    (recorded, not gated)."""
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.core.evaler import Evaler, run_eval
    from mafyolo_tpu_torch.data import device_aug as DA
    from mafyolo_tpu_torch.models.reparam import fold_variables
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, dw_sites, eval_set, train_set
    from mafyolo_tpu_torch.utils.timing import cuda_ms

    cfg = Config.fromfile(os.path.join(HERE, "configs", "maf_yolo_n.py"))
    sizes = [hw for hw, n in EVAL_SIZES.items() for _ in range(n)]
    sizes = [sizes[i] for i in np.random.default_rng(20).permutation(len(sizes))]
    data = {"train": train_set(40, TRAIN_IMAGES, size=IMG), "val": eval_set(20, sizes), "nc": NC,
            "names": [str(c) for c in range(NC)]}
    eval_batches = -(-len(sizes) // min(2 * BATCH, 64))
    tmp = tempfile.TemporaryDirectory()
    dir_a, dir_b = os.path.join(tmp.name, "a"), os.path.join(tmp.name, "b")

    def make(save_dir, **kw):
        args = SimpleNamespace(img_size=IMG, batch_size=BATCH, epochs=4, workers=8, seed=0,
                               save_dir=save_dir, device_aug=True, stop_aug_last_n_epoch=0,
                               tensorboard=False, **kw)
        return Trainer(args, cfg, data, device=dev, dataset_cls=ArrayDataset)

    def launches():
        return {"dw_grad": DG.dw_grad.launches, "frontend": FE.frontend_forward.launches,
                "greedy_nms": G.greedy_nms.launches}

    a = make(dir_a)
    n_sites = len(dw_sites(a.state.model, IMG, dev))
    check(a.max_stepnum == 3 and a.device_aug["mosaic"] == 1.0,
          f"trainer: {a.max_stepnum} steps an epoch, device_aug {a.device_aug}")

    # gate 2: the first batch through device_augment on the card and on the
    # CPU, on one draw
    imgs, targets, _ = next(iter(a.train_loader))
    x, t = torch.from_numpy(imgs).to(dev), torch.from_numpy(targets).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(DA.aug_seed(0, 0))
    drawn = DA.draw(*x.shape[:3], gen, **a.device_aug)
    card_img, card_lbl = DA.apply(x, t, drawn)
    cpu_img, cpu_lbl = DA.apply(x.cpu(), t.cpu(), DA.params_to(drawn, "cpu"))
    card_lbl = card_lbl.cpu()
    img_err = (card_img.cpu() - cpu_img).abs().max().item()
    live = cpu_lbl[..., 0] >= 0
    counts_equal = torch.equal(card_lbl[..., 0] >= 0, live)
    box_err_px = ((card_lbl - cpu_lbl)[live][:, 1:].abs().max().item() * IMG
                  if counts_equal else float("inf"))
    emit(phase="trainer_device_aug_check", batch=list(x.shape), card=card,
         mosaic=int(drawn["do_mo"].sum().item()), labels_in=int((t[..., 0] >= 0).sum().item()),
         labels_out=int(live.sum().item()), max_abs_err_img=img_err, max_box_err_px=box_err_px,
         tolerance=f"images {DEVICE_AUG_TOL}, equal label rows, boxes 1e-3 px")
    check(img_err <= DEVICE_AUG_TOL, f"device_augment card vs CPU: image error {img_err}")
    check(counts_equal and box_err_px <= 1e-3,
          f"device_augment card vs CPU: labels differ ({counts_equal}, {box_err_px} px)")
    del card_img, cpu_img

    # epochs 0-1 of A, every step watched (gates 1, 4, 5)
    record = []
    step_fn = a.train_step

    def watched(state, imgs, targets, lr_bnw, lr_w, lr_b, momentum, do_apply, use_atss,
                **kw):
        params = [(n, p) for n, p in state.model.named_parameters()]
        before = [p.detach().clone() for _, p in params]
        met = step_fn(state, imgs, targets, lr_bnw, lr_w, lr_b, momentum, do_apply,
                      use_atss, **kw)
        moved = sum(not torch.equal(p, b) for (_, p), b in zip(params, before))
        record.append({"batch": int(imgs.shape[0]), "applied": bool(do_apply),
                       "lr_weight": lr_w, "lr_bias": lr_b, "use_atss": use_atss,
                       "loss": {k: float(v) for k, v in met.items()},
                       "params_moved": moved, "params": len(params)})
        return met

    a.train_step = watched
    DG.dw_grad.launches = FE.frontend_forward.launches = G.greedy_nms.launches = 0
    ckpts, evals = [], []
    for epoch in (0, 1):
        before = launches()
        a.train_one_epoch(epoch)
        torch.cuda.synchronize()
        mid = launches()
        t0 = time.perf_counter()
        metrics = a.eval_and_save(epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launches()
        last = load_checkpoint(os.path.join(dir_a, "last_ckpt.npck"))
        ckpts.append({"epoch": epoch, "last_epoch": last["epoch"],
                      "best": os.path.exists(os.path.join(dir_a, "best_ckpt.npck"))})
        evals.append({"epoch": epoch, "metrics": metrics, "wall_s": wall,
                      "train_launches": {k: mid[k] - before[k] for k in mid},
                      "eval_launches": {k: after[k] - mid[k] for k in mid}})
    a.train_step = step_fn
    # the state at the end of epoch 1, which last_ckpt.npck holds
    snap = {"model": {k: v.clone() for k, v in a.state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in a.state.ema.state_dict().items()},
            "mom": {k: v.clone() for k, v in a._momentum().items()},
            "updates": a.state.updates}
    ema_vars = state_dict_to_train_variables(snap["ema"])
    t0 = time.perf_counter()
    fold_variables(a.state.model.specs, ema_vars)
    fold_s = time.perf_counter() - t0

    steps = len(record)
    short = [r["batch"] for r in record]
    train_dw = sum(e["train_launches"]["dw_grad"] for e in evals)
    emit(phase="trainer_epochs_0_1", card=card, steps=steps, batches=short,
         dw_sites=n_sites, dw_grad_launches=train_dw, evals=evals, checkpoints=ckpts,
         fold_ema_s=fold_s, steps_record=record)
    check(short == [BATCH, BATCH, TRAIN_IMAGES % BATCH] * 2, f"trainer batches {short}")
    check(train_dw == n_sites * steps, f"trainer: dw_grad launches {train_dw} != "
                                       f"{n_sites} sites x {steps} steps")
    check(all(e["train_launches"]["frontend"] == 0 for e in evals),
          "trainer: a train step launched the front-end kernel")
    check(evals[0]["metrics"] is None and evals[1]["metrics"] is not None,
          "trainer: eval schedule (epoch 1 of 4 evaluates, epoch 0 does not)")
    el = evals[1]["eval_launches"]
    check(el["frontend"] == eval_batches and el["greedy_nms"] >= eval_batches
          and el["dw_grad"] == 0, f"trainer eval launches {el} over {eval_batches} batches")
    for r in record:
        check(all(np.isfinite(v) for v in r["loss"].values()), f"trainer: loss {r['loss']}")
        check(r["params_moved"] > 0 if r["applied"] else r["params_moved"] == 0,
              f"trainer: parameters moved {r['params_moved']} on a step applied={r['applied']}")
    check(sum(r["applied"] for r in record) == a.state.updates > 0, "trainer: updates")
    check([c["last_epoch"] for c in ckpts] == [0, 1], f"trainer: last_ckpt {ckpts}")
    check(ckpts[1]["best"] == (a.best_ap > 0), f"trainer: best_ckpt {ckpts}, AP {a.best_ap}")

    # A goes on: epoch 2 under the profiler (the device's idle share), epoch
    # 3 timed (img/s, the loader and device aug included)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a.train_one_epoch(2)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_us, spans, by_name = device_busy(prof)
    check(busy_us > 0, "trainer: the profiler saw no device activity")
    t0 = time.perf_counter()
    a.train_one_epoch(3)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    # the loader alone over the same epoch (host only), then device_augment
    # and a whole step (augment included) by CUDA events
    t0 = time.perf_counter()
    n_loaded = sum(len(b[0]) for b in a.train_loader)
    loader_s = time.perf_counter() - t0
    aug_ms = cuda_ms(lambda: DA.device_augment(x, t, gen, **a.device_aug), 10)
    step_ms = cuda_ms(lambda: a._step(3, 3, (x, t)), 5)
    top = sorted(((n, us / 1e3) for n, us in by_name.items()), key=lambda kv: -kv[1])[:10]
    emit(phase="trainer_timing", card=card, model="maf-yolo-n", dtype="bf16", batch=BATCH,
         img=IMG, images=TRAIN_IMAGES, epoch_s=epoch_s, img_per_s=TRAIN_IMAGES / epoch_s,
         loader_alone_s=loader_s, loader_alone_img_per_s=n_loaded / loader_s,
         device_augment_ms=aug_ms, step_ms=step_ms,
         profiled_epoch={"wall_ms": prof_ms, "device_busy_ms": busy_us / 1e3,
                         "idle_share": 1 - busy_us / 1e3 / prof_ms, "device_ops": len(spans),
                         "top_ms": [[n[:80], v] for n, v in top]},
         eval_wall_s=evals[1]["wall_s"], eval_ap50=evals[1]["metrics"]["AP50"],
         eval_ap=evals[1]["metrics"]["AP"], fold_ema_s=fold_s,
         note="img_per_s: one epoch of train_one_epoch by the host clock to a synchronize "
              "(loader, copy, device aug, 3 steps); loader_alone: the same epoch's batches "
              "from the loader with no step; step_ms: a train step on a full batch "
              "(device aug included) by CUDA events; idle share: one more epoch under "
              "torch.profiler, the union of the device's spans against its wall time")
    steps_per_epoch = a.max_stepnum
    del a

    # gate 3: B resumes from A's checkpoint of epoch 1
    b = make(dir_b, resume=os.path.join(dir_a, "last_ckpt.npck"))
    diff = [k for k, v in b.state.model.state_dict().items() if not torch.equal(v, snap["model"][k])]
    diff += [f"ema {k}" for k, v in b.state.ema.state_dict().items()
             if not torch.equal(v, snap["ema"][k])]
    diff += [f"momentum {k}" for k, v in b._momentum().items() if not torch.equal(v, snap["mom"][k])]
    emit(phase="trainer_resume", card=card, start_epoch=b.start_epoch, updates=b.state.updates,
         updates_a=snap["updates"], entries_differing=len(diff), first=diff[:3])
    check(b.start_epoch == 2 and b.state.updates == snap["updates"] and not diff,
          f"trainer resume: start {b.start_epoch}, updates {b.state.updates}, differs {diff[:3]}")
    del snap
    before = launches()
    best = b.train()
    torch.cuda.synchronize()
    b_launches = {k: v - before[k] for k, v in launches().items()}

    # whether B's EMA gives boxes above conf 0.03 (recorded)
    ev = Evaler(half=True, device=dev)
    ev.init_model("maf-yolo-n", state_dict_to_train_variables(b.state.ema.state_dict()), NC)
    out = ev.predict(x)
    boxes_above = int(out["valid"].sum().item())
    max_score = max(o[1].float().max().item() for o in ev.forward(x))

    # gate 5: the stripped checkpoints evaluate
    path = os.path.join(dir_b, "last_ckpt.npck")
    stripped = load_checkpoint(path)
    leaves = [v for _, v in _tree_items(stripped["model"])]
    check("opt" not in stripped and stripped["ema"] is None and stripped["updates"] == 0
          and leaves and all(v.dtype == np.float16 for v in leaves),
          "trainer: last_ckpt.npck is not stripped")
    before = launches()
    m_stripped = run_eval("maf-yolo-n", eval_variables(stripped), NC, data, folded=False,
                          img_size=IMG, rect=True, batch_size=64, half=True, device=dev,
                          dataset_cls=ArrayDataset)
    torch.cuda.synchronize()
    s_launches = {k: v - before[k] for k, v in launches().items()}
    emit(phase="trainer_b", card=card, epochs=[2, 3], launches=b_launches, best_ap=best,
         files=sorted(os.listdir(dir_b)), stripped_eval=m_stripped,
         stripped_eval_launches=s_launches, ema_boxes_above_conf_0p03=boxes_above,
         ema_max_score=max_score, note="ema boxes: B's EMA through Evaler.predict on the "
                                       "first train batch (bf16, conf 0.03), recorded only")
    check(b_launches["dw_grad"] == n_sites * 2 * steps_per_epoch,
          f"trainer B: dw_grad launches {b_launches}")
    check(b_launches["frontend"] == eval_batches and s_launches["frontend"] == eval_batches
          and s_launches["greedy_nms"] >= eval_batches,
          f"trainer B evals: launches {b_launches}, stripped {s_launches}")
    check(all(np.isfinite(v) for v in m_stripped.values()), f"stripped eval {m_stripped}")
    tmp.cleanup()


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree_max_rel(got, want):
    """The largest |got - want| / want over two amax trees' leaves (inf when
    their paths differ)."""
    got = {"/".join(k): float(v) for k, v in _tree_items(got)}
    want = {"/".join(k): float(v) for k, v in _tree_items(want)}
    if got.keys() != want.keys():
        return float("inf")
    return max(abs(got[k] - want[k]) / want[k] for k in want)


def device_busy(prof):
    """(the union of the device's kernel, copy and set spans in us, the
    spans, us by name) of a torch.profiler run."""
    from torch.autograd import DeviceType
    return span_union(sorted((e.time_range.start, e.time_range.end, e.name)
                             for e in prof.events() if e.device_type == DeviceType.CUDA))


def span_union(spans):
    """(the union of sorted (start, end, name) spans in us, the spans, us by
    name)."""
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    return busy_us, spans, by_name


def _leaf_errors(got, want, floor=1e-2):
    """Largest |got - want| of each leaf over max(max|want leaf|, floor * the
    largest leaf magnitude); got and want map names to tensors."""
    top = max(w.abs().max().item() for w in want.values())
    return {k: (got[k].float().cpu() - w.float().cpu()).abs().max().item()
            / max(w.abs().max().item(), floor * top) for k, w in want.items()}


def train_phases(dev):
    """Phases 15-18: the train path on the card. Returns the dw_grad launches of
    the train run, the summed dk ms per step, kernel and plain, and the
    kernel's largest error at B=32."""
    import numpy as np
    import torch

    import tempfile
    from types import SimpleNamespace

    from mafyolo_tpu_torch.core.engine import Schedule, Trainer
    from torch.profiler import ProfilerActivity, profile
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import (ArrayDataset, cold_sets, dw_library,
                                                dw_site_inputs, dw_sites, in_turn, train_set)
    from mafyolo_tpu_torch.utils.timing import cuda_ms, graph_ms

    # ---- 15. train: N bs32@640 bf16 through the Trainer's step loop, on the
    # step schedule of a COCO epoch (its loader is not run here: phase 20)
    cfg = Config.fromfile(os.path.join(HERE, "configs", "maf_yolo_n.py"))
    with tempfile.TemporaryDirectory() as tmp:
        args = SimpleNamespace(img_size=IMG, batch_size=BATCH, epochs=300, workers=8, seed=0,
                               save_dir=tmp, tensorboard=False)
        tr = Trainer(args, cfg, {"train": train_set(30, BATCH), "nc": NC}, device=dev,
                     dataset_cls=ArrayDataset)
    tr.schedule = Schedule(cfg.solver, BATCH, 300, STEPS_PER_EPOCH)
    model = tr.state.model
    sites = dw_sites(model, IMG, dev)
    batches = [train_batch(200 + i, BATCH, IMG, dev) for i in range(2 * TRAIN_STEPS)]
    # nonzero conv kernels: weight decay moves each of them on every apply
    # step (BN params may sit still: the zero-initialized preds stop every
    # gradient upstream of the heads on the first step, and a zero pred moves
    # only when its level has positives)
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if p.ndim == 4 and bool(p.any())])
    stats = [b for n, b in model.named_buffers() if n.endswith("running_var")]
    ema0 = {k: v.clone() for k, v in tr.state.ema.state_dict().items()}
    record = []
    snap = {"p": [p.detach().clone() for p in params], "s": [b.clone() for b in stats],
            "u": tr.state.updates}

    def mark(stage):
        # compare with the end of the previous step, then take the new end
        if stage != "optimizer":
            return
        still = [n for n, a, p in zip(names, snap["p"], params) if torch.equal(a, p)]
        record.append({
            "applied": tr.state.updates != snap["u"],
            "params_moved": len(params) - len(still), "params_still": still[:4],
            "stats_moved": sum(not torch.equal(a, b) for a, b in zip(snap["s"], stats))})
        snap.update(p=[p.detach().clone() for p in params], s=[b.clone() for b in stats],
                    u=tr.state.updates)

    torch.cuda.synchronize()
    DG.dw_grad.launches = 0
    metrics = (tr._train_steps(2, batches[:TRAIN_STEPS], mark=mark)
               + tr._train_steps(3, batches[TRAIN_STEPS:], mark=mark))
    torch.cuda.synchronize()
    launches = DG.dw_grad.launches
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    ema_moved = sum(not torch.equal(v, ema0[k]) for k, v in tr.state.ema.state_dict().items())
    emit(phase="train", model="maf-yolo-n", dtype="bf16", batch=BATCH, img=IMG,
         steps=len(metrics), epochs=[2, 3], use_atss=[True, False],
         accumulate=tr.schedule.lrs(0, 2)["accumulate"], dw_sites=len(sites),
         dw_grad_launches=launches, updates=tr.state.updates,
         ema_entries_moved=ema_moved, steps_record=record, losses=losses)
    for r, lo in zip(record, losses):
        check(all(np.isfinite(v) for v in lo.values()), f"non-finite loss {lo}")
        check(r["params_moved"] == (len(params) if r["applied"] else 0),
              f"conv kernels moved {r['params_moved']}/{len(params)} on a step "
              f"applied={r['applied']}")
        check(r["stats_moved"] == len(stats), f"BN stats moved {r['stats_moved']}/{len(stats)}")
    n_apply = sum(r["applied"] for r in record)
    check(0 < n_apply < len(record), f"{n_apply} apply steps of {len(record)}")
    check(tr.state.updates == n_apply and ema_moved > 0, "updates or EMA did not move")
    check(launches == len(sites) * len(record),
          f"dw_grad launches {launches} != {len(sites)} DW sites x {len(record)} steps")

    # ---- 16. train_check: one f32 step, card (kernel) vs CPU (plain), bs2@160
    step_card_vs_cpu(dev, "maf-yolo-n", len(sites))

    # ---- 17. train_to_serve: fold the EMA, predict on the card
    serve_ema(dev, "maf-yolo-n", state_dict_to_train_variables(tr.state.ema.state_dict()),
              batches[0][0])

    # ---- 18. timing_train: CUDA events per stage over steady steps
    stages = ("forward", "loss", "backward", "optimizer")
    timed = []

    def mark_t(stage):
        ev_ = torch.cuda.Event(enable_timing=True)
        ev_.record()
        timed[-1][stage] = ev_

    tr._train_steps(4, batches[:2])                             # warm-up
    torch.cuda.reset_peak_memory_stats()
    for i, (im, tg) in enumerate(batches[2:8]):
        sched, do_apply = tr.schedule.plan(2 + i, 4)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        timed.append({"start": start, "applied": do_apply})
        tr.train_step(tr.state, im, tg, sched["lr_bnw"], sched["lr_weight"],
                      sched["lr_bias"], sched["momentum"], do_apply, False, mark=mark_t)
    torch.cuda.synchronize()
    per = {s_: [] for s_ in stages}
    step_ms = []
    for t in timed:
        prev = t["start"]
        for s_ in stages:
            per[s_].append(prev.elapsed_time(t[s_]))
            prev = t[s_]
        step_ms.append((t["start"].elapsed_time(t["optimizer"]), t["applied"]))
    mean_ms = float(np.mean([m for m, _ in step_ms]))

    # the device's busy time over two more steps (one apply, one
    # accumulate-only) under the profiler: the union of its kernel, copy and
    # set spans, against those steps' span by CUDA events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p0, p1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        p0.record()
        for i, (im, tg) in enumerate(batches[:2]):
            sched, do_apply = tr.schedule.plan(8 + i, 4)
            tr.train_step(tr.state, im, tg, sched["lr_bnw"], sched["lr_weight"],
                          sched["lr_bias"], sched["momentum"], do_apply, False)
        p1.record()
        torch.cuda.synchronize()
    prof_ms = p0.elapsed_time(p1)
    busy_us, spans, by_name = device_busy(prof)
    top = sorted(((n, t / 2e3) for n, t in by_name.items()), key=lambda kv: -kv[1])[:15]
    emit(phase="profile_train", steps=2, step_ms_profiled=prof_ms / 2,
         device_busy_ms_per_step=busy_us / 2e3, idle_share=1 - busy_us / 1e3 / prof_ms,
         device_ops_per_step=len(spans) / 2,
         top_ms_per_step=[[n[:100], t] for n, t in top])
    check(busy_us > 0, "profile_train: the profiler saw no device activity")

    # the dw_grad kernel against its plain version at every site at B=32
    # (up to 819 200 terms per tap, several tiles per block, the path's
    # n_split), then the summed dk time per step, kernel against plain
    # (CUDA events around eager calls, and the same calls replayed from a CUDA
    # graph: device time with the host out of the way), split by class of
    # site (H, k); aten's weight gradient of the same conv is timed beside
    # it and never called by the port. The timed calls of the kernel and of
    # aten take copies of x and g in turn, enough of them that no call finds
    # its input in the L2 cache, as in a train step (a 20 px site's x and g
    # are 10-29 MB, and the cache holds 50)
    keys = ("kernel_ms", "kernel_device_ms", "library_ms", "library_device_ms", "plain_ms",
            "bound_ms")
    per_class, b32_err, b32_rel = {}, 0.0, 0.0
    dk_bytes = dk_flops = 0
    launches_before = DG.dw_grad.launches
    for site in sorted(set(sites)):
        c, h, w, k, pad, dil = site
        count = sites.count(site)
        x, g = dw_site_inputs(site, BATCH, dev)
        got = DG.dw_grad(x, g, k, pad, dil)
        want = DG.dw_grad_plain(x, g, k, pad, dil)
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        check(err <= 1e-3 * scale, f"dw_grad kernel vs plain at B={BATCH} C{c} H{h} k{k}: "
                                   f"{err} > 1e-3 * {scale}")
        check(torch.equal(got, DG.dw_grad(x, g, k, pad, dil)),
              f"dw_grad not deterministic at B={BATCH} C{c} H{h} k{k}")
        b32_err, b32_rel = max(b32_err, err), max(b32_rel, err / scale)
        sets = cold_sets((x, g))

        def kernel(x, g):
            return DG.dw_grad(x, g, k, pad, dil)
        library = dw_library(x, k, pad, dil)
        nbytes, flops = 2 * x.numel() * 2 + c * k * k * 4, 2 * k * k * x.numel()
        rec = (cuda_ms(in_turn(kernel, sets), iters=20),
               graph_ms(in_turn(kernel, sets), 10),
               cuda_ms(in_turn(library, sets), iters=20),
               graph_ms(in_turn(library, sets), 10),
               cuda_ms(lambda: DG.dw_grad_plain(x, g, k, pad, dil), iters=2, warmup=1),
               bound(nbytes, flops, "bf16")["bound_ms"])
        cls = per_class.setdefault(f"h{h}k{k}", {"sites": 0, **dict.fromkeys(keys, 0.0)})
        cls["sites"] += count
        for key, v in zip(keys, rec):
            cls[key] += count * v
        dk_bytes += count * nbytes
        dk_flops += count * flops
    DG.dw_grad.launches = launches_before     # check and timing launches are not the path's
    dk_ms, dk_device_ms, dk_library_ms, dk_library_device_ms, dk_plain_ms = (
        sum(v[key] for v in per_class.values()) for key in keys[:5])
    slower, slower_device = (
        {n: v[f"kernel_{m}"] / v[f"library_{m}"] for n, v in per_class.items()
         if v[f"kernel_{m}"] > v[f"library_{m}"]} for m in ("ms", "device_ms"))
    emit(phase="dw_grad_check_b32", sites=len(sites), batch=BATCH, dtype="bf16",
         max_abs_err=b32_err, max_rel_err=b32_rel,
         tolerance="1e-3 * max|plain| at each site; bit-identical on a second launch")
    emit(phase="timing_train", model="maf-yolo-n", dtype="bf16", batch=BATCH, img=IMG,
         steps=len(step_ms), img_per_s=BATCH / (mean_ms / 1e3), step_ms_mean=mean_ms,
         apply_step_ms=float(np.mean([m for m, a in step_ms if a])),
         accumulate_step_ms=float(np.mean([m for m, a in step_ms if not a])),
         **{f"{s_}_ms": float(np.mean(v)) for s_, v in per.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         dk_sites=len(sites), dk_kernel_ms_per_step=dk_ms, dk_plain_ms_per_step=dk_plain_ms,
         dk_library_ms=dk_library_ms, dk_kernel_device_ms_per_step=dk_device_ms,
         dk_library_device_ms=dk_library_device_ms, dk_bound=bound(dk_bytes, dk_flops, "bf16"),
         dk_per_class=per_class, dk_classes_slower_than_library=slower,
         dk_classes_slower_than_library_device=slower_device,
         note="*_ms: CUDA events around eager calls; *_device_ms: the same calls replayed "
              "from a CUDA graph; both on inputs that are not in the L2 cache")
    return {"launches": launches, "dk_ms": dk_ms, "dk_plain_ms": dk_plain_ms,
            "dk_err": b32_err, "dk_library_ms": dk_library_ms,
            "dk_bound": bound(dk_bytes, dk_flops, "bf16")}


def step_card_vs_cpu(dev, graph, n_sites, phase="train_check", recipe=None, label=None,
                     dtype=None, gate=True, remat=False):
    """One f32 step of `graph` at bs2@160 on the card (the dw_grad kernel)
    against the CPU (its plain version), from the same random train weights:
    loss components (and Wise-IoU's running mean) within 1e-3, each gradient
    and BN buffer within 1e-2 of its scale; the card's step launches dw_grad
    once a DW site. dtype=torch.float64 runs both models in f64 (a graph
    without DW sites: dw_grad takes f32 and bf16); gate=False records the
    errors without holding them to the tolerances (the dw_grad count is held
    either way). recipe (recipes_phase's RECIPES entry) gives the step's
    loss and its inputs: the plain graph re-initialized and masked by
    repopt_prepare from the same scales, or a teacher from other random
    weights, on both sides alike. remat builds both models with per-block
    rematerialization (policy "full")."""
    import numpy as np
    import torch

    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.solver import repopt as R
    from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                                train_variables_to_state_dict)
    cl = torch.channels_last
    recipe = recipe or {}
    plain = recipe.get("training_mode") == "repopt"
    variables = random_train_variables(build_model(graph, nc=NC, plain_rep=plain).specs, seed=3,
                                       plain_rep=plain)
    imgs, targets = train_batch(7, 2, 160, dev)
    grads, comps, bn = {}, {}, {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        m = build_model(graph, nc=NC, plain_rep=plain, remat=remat)
        m.load_state_dict(train_variables_to_state_dict(variables))
        kw = {k: recipe[k] for k in ("loss_type", "iou_type") if k in recipe}
        if plain:
            masks = R.repopt_prepare(m, R.random_scales_like(m, np.random.default_rng(1)),
                                     np.random.default_rng(2))
            kw["grad_mask"] = {n: v.to(where) for n, v in masks.items()}
        if recipe.get("loss_type") == "distill":
            t = build_model(graph, nc=NC)
            t.load_state_dict(train_variables_to_state_dict(
                random_train_variables(t.specs, seed=4)))
            kw.update(teacher=t.to(where).to(memory_format=cl), distill_feat=True)
        m = m.to(where, dtype or torch.float32).to(memory_format=cl)
        st = init_train_state(m, weight_decay=5e-4)
        before = DG.dw_grad.launches
        met = make_train_step(num_classes=NC, img_size=160, **kw)(
            st, imgs.to(where), targets.to(where), 0.01, 0.01, 0.01, 0.9, False, False,
            epoch_num=RECIPE_EPOCH)
        if key == "card":
            check(DG.dw_grad.launches - before == n_sites, f"{phase}: dw_grad not launched")
        comps[key] = {k: float(v) for k, v in met.items()}
        comps[key]["wiou_mean"] = float(st.wiou_mean)
        grads[key] = {n: p.grad for n, p in m.named_parameters()}
        bn[key] = {n: b for n, b in m.named_buffers()}
    g_err = _leaf_errors(grads["card"], grads["cpu"])
    s_err = _leaf_errors(bn["card"], bn["cpu"])
    l_err = max(abs(comps["card"][k] - v) / max(abs(v), 1e-6) for k, v in comps["cpu"].items())
    worst = sorted(g_err.items(), key=lambda kv: -kv[1])[:3]
    emit(phase=phase, model=label or (graph if isinstance(graph, str)
                                      else "maf-yolo-n (Head_simota)"),
         recipe={k: v for k, v in recipe.items() if k != "graph"}, batch=2, img=160,
         remat=remat,
         gated=gate, dtype=str(dtype or torch.float32).replace("torch.", ""),
         loss_cpu=comps["cpu"], loss_card=comps["card"], loss_rel_err=l_err,
         grad_leaves=len(g_err), grad_max_rel_err=max(g_err.values()), grad_worst=worst,
         bn_stats_max_rel_err=max(s_err.values()),
         tolerance="loss components rel 1e-3; each gradient and BN buffer: "
                   "max|card - cpu| <= 1e-2 * max(max|cpu leaf|, 1e-2 * max over leaves)")
    if not gate:
        return
    check(l_err <= 1e-3, f"{phase} loss components differ: {comps}")
    check(max(g_err.values()) <= 1e-2, f"{phase} gradients differ: {worst}")
    check(max(s_err.values()) <= 1e-2, f"{phase} BN running stats differ")


def serve_ema(dev, graph, ema_vars, imgs, phase="train_to_serve", label=None):
    """The EMA folded and served through Evaler.predict on imgs (bs32@640),
    with the front-end and NMS launches read around it; the fold checked on
    raw outputs: the folded model in f32 (front-end kernel included) against
    the train form in eval mode on the same EMA weights, 4 images, at every
    head's stem (feat), cls_proj and reg_proj (an office head's cls_conv and
    reg_conv) output and its cls and reg.
    After a few optimizer steps the EMA's preds are still near their zero
    init, so every score sits near the prior (0.01) and few or no boxes
    clear conf 0.03: the boxes are checked for shape and finiteness only."""
    import torch

    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.utils.bridge import train_variables_to_state_dict
    ev = Evaler(half=True, device=dev)
    ev.init_model(graph, ema_vars, nc=NC, folded=False)
    FE.frontend_forward.launches = G.greedy_nms.launches = 0
    out = ev.predict(imgs)
    torch.cuda.synchronize()
    serve_launches = {"frontend": FE.frontend_forward.launches, "greedy_nms": G.greedy_nms.launches}
    ev32 = Evaler(half=False, device=dev)
    ev32.init_model(graph, ema_vars, nc=NC, folded=False)
    ref = build_model(graph, nc=NC)
    ref.load_state_dict(train_variables_to_state_dict(ema_vars))
    ref = ref.to(dev).to(memory_format=torch.channels_last).eval()

    def inner(model, run):
        got, hooks = {}, []
        for name, m in model.named_modules():
            if name.endswith(("cls_proj", "reg_proj", "cls_conv", "reg_conv")):
                hooks.append(m.register_forward_hook(
                    lambda mod, a, o, name=name: got.__setitem__(name, o)))
        with torch.no_grad():
            for lvl, outs in enumerate(run()):
                got.update({f"level{lvl}.{t}": o for t, o in zip(("feat", "cls", "reg"), outs)})
        for h in hooks:
            h.remove()
        return got

    four = imgs[:4]
    got = inner(ev32.model, lambda: ev32.forward(four))
    want = inner(ref, lambda: ref(four.flip(-1).float() / 255.0))
    check(got.keys() == want.keys() and len(want) == 15, f"{phase}: outputs differ in kind")
    fold_err = {k: (got[k].float() - w).abs().max().item() / w.abs().max().item()
                for k, w in want.items()}
    emit(phase=phase, model=label or graph, launches=serve_launches,
         dets_per_image_mean=float(out["valid"].sum(1).float().mean().item()),
         max_score=max(o[1].float().max().item() for o in ev.forward(four)),
         fold_outputs=len(fold_err), fold_max_rel_err=max(fold_err.values()),
         fold_worst=sorted(fold_err.items(), key=lambda kv: -kv[1])[:3],
         tolerance="folded f32 vs train form eval f32: max|err| <= 1e-3 * max|train form| "
                   "for each output")
    check(serve_launches["frontend"] == 1 and serve_launches["greedy_nms"] >= 1,
          f"{phase}: front-end or NMS kernel not launched")
    check(out["boxes"].shape == (imgs.shape[0], 300, 4)
          and bool(torch.isfinite(out["boxes"]).all())
          and bool(torch.isfinite(out["scores"]).all()), f"{phase}: bad output")
    check(max(fold_err.values()) <= 1e-3, f"{phase}: folded model differs from the "
                                          f"train form: {fold_err}")
    return serve_launches


# The least share of detections (score > 0.1, match()'s criterion) that the
# int8 predict matches: of the int8-sim (f32 fake-quant) predict of the same
# bs32 batch, and of the CPU's int8 predict (f32 activations) of the same 2
# images. 0.6 x the first card run's shares, 72 / 766 and 51 / 57 (PERF.md
# §6, the int8 entry; NVIDIA H100 80GB HBM3, 700.00 W). The int8 graph is
# discontinuous: an activation moved by one rounding (bf16 against f32, or
# the card's SiLU against the CPU's in the last bit) that sits at a half of
# a quantization step flips it, and the flip spreads through the layers
# after it; random heads then move scores past match()'s 0.01.
INT8_SHARE_FLOOR = {"int8_sim": 0.056, "cpu": 0.537}
QUANT_BATCHES = 4           # bs32@640 batches of the int8 predict


def _odd_int8_sites(dev):
    """(tag, pack, input, act) of int8 convs at shapes the model does not
    give: Cin 3 at 2x126x94 and at odd 67x45 (3x3 s2), a 3x3 stride-2 conv at
    odd H and W, C of 1, 33 and 72, 24-channel 41x39 (3 x 19 tiles), every DW
    kernel size on 37x23, the depthwise tile edges of N's sites (k 9 on a
    whole 20x20 image at C 288, k 7 on 40x40 at C 144, k 3 at C 72 across
    16-pixel tiles of 41x39); the 3x3 stride-1 kernel's edges (H and W no
    multiple of its tile, C of 24 and 40 padded to 32 and 64, O of 72 and
    136 no multiple of its N tile, 1x1 and 3x5 images); nonzero biases
    (U(0.2, 1)); bf16 and f32 inputs; the dense ones also with SiLU and with
    ReLU fused."""
    import torch

    from mafyolo_tpu_torch.ops import quant_conv as QC
    gen = torch.Generator().manual_seed(12)
    out = []
    for shape, o, k, stride, groups in (((2, 3, 126, 94), 16, 3, 2, 1),
                                        ((1, 3, 67, 45), 24, 3, 2, 1),
                                        ((2, 33, 63, 47), 72, 3, 2, 1),
                                        ((2, 24, 41, 39), 48, 3, 2, 1),
                                        ((2, 1, 40, 40), 33, 1, 1, 1),
                                        ((2, 72, 37, 23), 1, 1, 1, 1),
                                        ((2, 33, 37, 23), 33, 3, 1, 33),
                                        ((2, 72, 37, 23), 72, 5, 1, 72),
                                        ((2, 1, 37, 23), 1, 7, 1, 1),
                                        ((2, 72, 37, 23), 72, 9, 1, 72),
                                        ((2, 288, 20, 20), 288, 9, 1, 288),
                                        ((2, 144, 40, 40), 144, 7, 1, 144),
                                        ((2, 72, 41, 39), 72, 3, 1, 72),
                                        ((2, 24, 41, 39), 72, 3, 1, 1),
                                        ((2, 40, 23, 17), 136, 3, 1, 1),
                                        ((1, 24, 1, 1), 40, 3, 1, 1),
                                        ((2, 40, 3, 5), 24, 3, 1, 1)):
        w = torch.randn((o, shape[1] // groups, k, k), generator=gen)
        bias = torch.rand((o,), generator=gen) * 0.8 + 0.2
        pad = k // 2 if stride == 1 else (k - 1) // 2
        p = QC.pack(w, bias, torch.tensor(2.5), stride, pad, groups).to(dev)
        x = torch.randn(shape, generator=gen) * 1.2 + 0.3
        acts = (None, "silu", "relu") if p.kind == "dense" else (None,)
        for dt in (torch.bfloat16, torch.float32):
            for act in acts:
                out.append((f"{shape}->{o} k{k}s{stride}g{groups} {dt} {act}", p,
                            x.to(dev, dt).contiguous(memory_format=torch.channels_last), act))
    return out


def distinct_int8_cases(seen):
    """The distinct int8 conv sites of int8_inputs' {module: (pack, input,
    act)} (by kind, widths, k, stride, input size and activation) -> (their
    number, the cases (tag, pack, input, act): each site with the
    activation its launch fuses, and without it)."""
    distinct = {}
    for mname, (p, x, act) in seen.items():
        distinct.setdefault((p.kind, p.cin, p.cout, p.k, p.stride, tuple(x.shape[2:]), act),
                            (mname, p, x, act))
    return len(distinct), [c for mname, p, x, act in distinct.values()
                           for c in ((mname, p, x, act),) + (((mname, p, x, None),) if act
                                                              else ())]


def check_int8_cases(cases, what):
    """Each case's int8 kernel (then torch's activation) against its plain
    version bit for bit, and a second launch bit-identical; a 3x3 stride-1
    pad-1 dense case must take the 3x3 kernel both times, any other dense
    case never -> (the largest |difference| by kind and for the 3x3
    stride-1 cases, a record a case)."""
    import torch

    from mafyolo_tpu_torch.ops import quant_conv as QC
    err, records = {"dense": 0.0, "dw": 0.0, "3x3s1": 0.0}, []
    for tag, p, x, act in cases:
        before = QC.int8_conv.launches_3x3
        got, again = QC.int8_conv(x, p, act), QC.int8_conv(x, p, act)
        three = p.kind == "dense" and QC.is_3x3s1(p.k, p.stride, p.pad)
        check(QC.int8_conv.launches_3x3 - before == 2 * three,
              f"{what}int8 {tag}: {QC.int8_conv.launches_3x3 - before} launches of the 3x3 "
              f"stride-1 kernel in two calls")
        want = QC.ACTS[act](QC.int8_conv_plain(x, p))
        e = (got.float() - want.float()).abs().max().item()
        err[p.kind] = max(err[p.kind], e)
        if three:
            err["3x3s1"] = max(err["3x3s1"], e)
        records.append([tag, p.kind, list(x.shape), p.cout, p.k, p.stride, act, e])
        check(torch.equal(got, want), f"{what}int8 {p.kind} kernel differs from plain at {tag} "
              f"({act}): {e}")
        check(torch.equal(got, again),
              f"{what}int8 {p.kind} kernel: a second launch differs at {tag}")
    return err, records


def share_split(tag, ref, got, dec_ref, dec_got, conf=0.03, same_tol=1e-3):
    """One comparison of two int8 predicts of the same batch: the share of
    `ref`'s detections (score > 0.1) that `got` matches (match()); the
    largest and mean |dscore| over the live (anchor, class) pairs, those
    above conf on either side (random_deploy leaves 2 live classes a head
    level: the other 74 sit at bias -30); and each unmatched reference
    detection sorted by its own anchor-class score on the two sides: within
    same_tol of each other (an NMS survivor flip: the same score, another
    survivor or box) or moved. dec_* are decode_eval outputs, on the CPU."""
    import torch
    unmatched = []
    n, m = match(ref, got, 0.1, unmatched)
    sr, sg = dec_ref[..., 5:].float(), dec_got[..., 5:].float()
    live = (sr > conf) | (sg > conf)
    d = (sr - sg).abs()[live]
    xy, wh = dec_ref[..., :2].float(), dec_ref[..., 2:4].float()
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    flips = moved = 0
    for i, bx, c, sc in unmatched:
        a = ((boxes[i] - bx).abs().amax(-1) + (sr[i, :, c] - sc).abs()).argmin()
        if (sr[i, a, c] - sg[i, a, c]).abs().item() <= same_tol:
            flips += 1
        else:
            moved += 1
    return {"split": tag, "ref_dets_above_0p1": n, "matched": m, "share": m / max(n, 1),
            "live_pairs": int(live.sum()), "live_dscore_max": d.max().item(),
            "live_dscore_mean": d.mean().item(), "unmatched": n - m,
            "unmatched_same_score": flips, "unmatched_score_moved": moved}


def quant_phase(dev, folded, card, conf_over):
    """Phase 21: MAF-YOLO-N served in real int8 (core/quant.py) on the card.

    quant_calib: PTQ max calibration over QUANT_BATCHES bs32@640 batches
    (all 88 amax > 0); 2 images calibrated on the card and on the CPU
    (plain versions) agree at rtol 1e-5; percentile calibration once (every
    amax in (0, its max]). int8_conv_check: the int8 kernels against their
    plain versions (then torch's activation) on the real bf16 input of every
    distinct int8 conv site of N (bs2@640), with the activation its launch
    fuses and without, and at _odd_int8_sites, bit for bit, a second launch
    bit-identical; the fused SiLU on every finite bf16 value
    (utils/sample.py:int8_silu_every_bf16). quant_int8: int8_predict_fn
    (bf16) over QUANT_BATCHES bs32@640 batches with every launch count read
    around that run: 66
    int8_conv and 16 int8_dw launches a predict, 1 NMS launch a batch (9 on
    overflow), no front-end launch; int8 against quantized_predict_fn
    (fake-quant, f32) on a batch: mean |cls| of the decodes < 0.02 and the
    share of int8-sim detections (score > 0.1) matched at least
    INT8_SHARE_FLOOR["int8_sim"]; card int8 in f32 against the CPU's on 2
    images, at least INT8_SHARE_FLOOR["cpu"] matched; int8_share_split:
    that int8-sim share split into the quant effect (int8-real in f32
    against int8-sim) and the dtype effect (int8-real bf16 against f32),
    each with its share, live-class |dscore| and NMS survivor flips
    (share_split), reported, not gated. quant_qat: two QAT
    steps at bs8@320 (finite losses, parameters moved), the first loss of 2
    images on the card against the CPU's at rtol 1e-3, both in f64.
    quant_cli: tools/quantize.run --eval on the eval
    phase's images held in memory (fp, int8-sim, int8-real AP).
    timing_quant: img/s of int8-sim on the phase's batches, and int8-real
    and the bf16 float predict with their device busy ms a batch and idle
    share, as graphs_check timed their graphs; per site and per class of site the int8 kernel's
    ms on warm and on cold inputs, its plain version's, its launches, its
    bound, and the yardsticks (tools/tune_kernels.py:time_int8_site):
    torch._int_mm on the dense sites' quantized operands, cuDNN's bf16 conv
    of each site (no int8 conv exists in PyTorch on the card). The kernels
    line's ms is the cold sum."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from mafyolo_tpu_torch.core import quant as Q
    from mafyolo_tpu_torch.models.detect import decode_eval
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops import quant_conv as QC
    from mafyolo_tpu_torch.tools import quantize as QT
    from mafyolo_tpu_torch.tools.tune_kernels import int8_inputs, time_int8_model
    from mafyolo_tpu_torch.utils.sample import (ArrayDataset, eval_set, images,
                                                int8_silu_every_bf16)
    name, bf16 = "maf-yolo-n", torch.bfloat16

    # ---- quant_calib
    calib = [images(300 + i, BATCH).to(dev) for i in range(QUANT_BATCHES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant = Q.ptq_calibrate(name, NC, folded, calib, max_batches=QUANT_BATCHES, device=dev)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    amax = {"/".join(k): float(v) for k, v in _tree_items(quant)}
    check(len(amax) == 88 and min(amax.values()) > 0, f"calibration: {len(amax)} leaves, "
          f"min {min(amax.values())}")
    two = images(7, 2)
    calib_rel = _tree_max_rel(
        Q.ptq_calibrate(name, NC, folded, [two.to(dev)], max_batches=1, device=dev),
        Q.ptq_calibrate(name, NC, folded, [two], max_batches=1, device="cpu"))
    t0 = time.perf_counter()
    pct = {"/".join(k): float(v) for k, v in _tree_items(Q.ptq_calibrate(
        name, NC, folded, calib, max_batches=QUANT_BATCHES, method="percentile", device=dev))}
    pct_s = time.perf_counter() - t0
    emit(phase="quant_calib", batches=QUANT_BATCHES, batch=BATCH, img=IMG, leaves=len(amax),
         seconds=calib_s, percentile_seconds=pct_s, card_vs_cpu_max_rel=calib_rel,
         percentile_clipped=sum(pct[k] < amax[k] for k in amax),
         amax_min=min(amax.values()), amax_max=max(amax.values()))
    check(calib_rel <= 1e-5, f"calibration card vs CPU: max rel {calib_rel}")
    check(pct.keys() == amax.keys() and all(0 < pct[k] <= amax[k] for k in amax),
          "percentile calibration: an amax outside (0, max]")

    # ---- int8_conv_check: every distinct site of N at bs2@640, then odd shapes
    p8 = Q.int8_predict_fn(name, NC, folded, quant, device=dev)
    seen = int8_inputs(p8.model, Q.normalize(images(9, 2), bf16, dev))
    kinds = [p.kind for p, _, _ in seen.values()]
    check(len(seen) == 82 and kinds.count("dense") == 66 and kinds.count("dw") == 16,
          f"int8 sites: {len(seen)} ({kinds.count('dense')} dense, {kinds.count('dw')} dw)")
    n_distinct, site_cases = distinct_int8_cases(seen)
    cases = site_cases + _odd_int8_sites(dev)
    conv_err, records = check_int8_cases(cases, "")
    n_vals, silu_diff = int8_silu_every_bf16(dev)
    emit(phase="int8_conv_check", sites=n_distinct, cases=len(cases),
         odd_cases=len(cases) - len(site_cases),
         max_abs_err=conv_err, fused_acts=list(QC.FUSED_ACTS), silu_bf16_values=n_vals,
         silu_bf16_differ=silu_diff, records=records)
    check(silu_diff == 0, f"fused SiLU differs from torch's on {silu_diff} bf16 values")

    # ---- quant_int8: the int8 predict, launch counts read around it
    psim = Q.quantized_predict_fn(name, NC, folded, quant, device=dev)
    batches = [images(400 + i, BATCH).to(dev) for i in range(QUANT_BATCHES)]
    torch.cuda.synchronize()
    QC.int8_conv.launches = QC.int8_dw.launches = QC.int8_conv.launches_3x3 = 0
    G.greedy_nms.launches = FE.frontend_forward.launches = 0
    outs8, nms_per = [], []
    for bt in batches:
        before = G.greedy_nms.launches
        outs8.append(p8(bt))
        nms_per.append(G.greedy_nms.launches - before)
    torch.cuda.synchronize()
    launches = {"int8_conv": QC.int8_conv.launches, "int8_dw": QC.int8_dw.launches,
                "greedy_nms": G.greedy_nms.launches, "frontend": FE.frontend_forward.launches,
                "int8_conv3x3": QC.int8_conv.launches_3x3}
    n = len(batches)
    check(launches["int8_conv"] == 66 * n and launches["int8_dw"] == 16 * n
          and launches["int8_conv3x3"] == 0, f"int8 launches {launches} over {n} predicts")
    check(launches["frontend"] == 0, f"the int8 predict launched the front-end kernel: {launches}")
    check(all(k in (1, 9) for k in nms_per), f"NMS launches a batch: {nms_per}")
    graphs_check("maf-yolo-n int8", card, p8.graphs, p8, p8.eager, batches, conf_over)
    check_dets(outs8, BATCH, "int8 predict")
    x8, x32 = Q.normalize(batches[0], bf16, dev), Q.normalize(batches[0], torch.float32, dev)
    cls8 = decode_eval(p8.model(x8), (8, 16, 32))[..., 5:].float()
    cls_sim = decode_eval(psim.model(x32), (8, 16, 32))[..., 5:].float()
    dcls = (cls8 - cls_sim).abs()
    n_sim, m_sim = match(on_cpu(psim(batches[0])), on_cpu(outs8[0]), 0.1)
    p8_32 = Q.int8_predict_fn(name, NC, folded, quant, dtype=torch.float32, device=dev)
    # the int8-sim share split: the quant effect (int8-real against int8-sim,
    # both f32) and the dtype effect (int8-real bf16 against int8-real f32)
    dets = {"real": on_cpu(outs8[0]), "real_f32": on_cpu(p8_32(batches[0])),
            "sim": on_cpu(psim(batches[0]))}
    decs = {"real": decode_eval(p8.model(x8), (8, 16, 32)).cpu(),
            "real_f32": decode_eval(p8_32.model(x32), (8, 16, 32)).cpu(),
            "sim": decode_eval(psim.model(x32), (8, 16, 32)).cpu()}
    splits = [share_split(tag, dets[r], dets[g], decs[r], decs[g])
              for tag, r, g in (("int8_sim_vs_real_bf16", "sim", "real"),
                                ("quant_f32", "sim", "real_f32"),
                                ("dtype_real", "real_f32", "real"))]
    # the quant effect layer by layer: each site's int8 kernel (f32) against
    # the int8-sim module on the same input; the sim rounds its operands once
    # more (x + (q - x)), sums in f32 and clips at -128 where real clips at -127
    sims = dict(psim.model.named_modules())
    layer_rel = []
    for mname, (p, xi, _) in int8_inputs(p8_32.model, x32).items():
        y_real, y_sim = QC.int8_conv(xi, p), sims[mname](xi)
        layer_rel.append((((y_real - y_sim).abs().max() / y_sim.abs().max().clamp_min(1e-30))
                          .item(), mname, int((xi.float() / p.x_scale_t < -127.5).sum())))
    layer_rel.sort(reverse=True)
    emit(phase="int8_share_split", splits=splits, layer_max_rel_real_vs_sim=layer_rel[:5],
         sim_inputs_below_m127p5=sum(r[2] for r in layer_rel),
         note="share: of ref's detections above 0.1 matched by got; live_dscore over "
              "(anchor, class) pairs above conf 0.03 on either side; unmatched_same_score: "
              "the anchor-class score within 1e-3 on both sides (an NMS survivor flip); "
              "layer_max_rel: over the 82 sites, max |kernel - sim module| / max |sim| "
              "on the f32 int8 model's own inputs of one bs32 forward")
    del decs
    p8_cpu = Q.int8_predict_fn(name, NC, folded, quant, dtype=torch.float32, device="cpu")
    n_cpu, m_cpu = match(p8_cpu(two), on_cpu(p8_32(two.to(dev))), 0.1)
    emit(phase="quant_int8", batches=n, launches=launches, nms_launches_per_batch=nms_per,
         int8_conv_per_predict=launches["int8_conv"] / n,
         int8_dw_per_predict=launches["int8_dw"] / n,
         dets_per_image_mean=float(torch.cat([o["valid"].sum(1) for o in outs8]).float()
                                   .mean().item()),
         cls_diff_mean=dcls.mean().item(), cls_diff_max=dcls.max().item(),
         sim_dets_above_0p1=n_sim, int8_matched=m_sim, int8_share=m_sim / max(n_sim, 1),
         cpu_dets_above_0p1=n_cpu, cpu_matched=m_cpu, cpu_share=m_cpu / max(n_cpu, 1),
         share_floors=INT8_SHARE_FLOOR)
    check(dcls.mean().item() < 0.02, f"int8 vs int8-sim: mean |cls| {dcls.mean().item()}")
    check(n_sim > 0 and m_sim / n_sim >= INT8_SHARE_FLOOR["int8_sim"],
          f"int8 vs int8-sim: {m_sim}/{n_sim} detections matched")
    check(n_cpu >= 10 and m_cpu / n_cpu >= INT8_SHARE_FLOOR["cpu"],
          f"int8 card vs CPU: {m_cpu}/{n_cpu} detections matched")
    del p8_32, p8_cpu

    # ---- quant_qat: two steps at bs8@320; the first loss against the CPU's
    class Batches:
        def __init__(self, items):
            self.items = items

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            return iter(self.items)

    torch.set_grad_enabled(True)
    steps = [train_batch(500 + i, 8, 320, dev) + (None,) for i in range(2)]
    losses = []
    qat = Q.qat_finetune(name, NC, folded, quant, Batches(steps), img_size=320, epochs=1,
                         device=dev, losses=losses)
    before = dict(_tree_items(folded["params"]))
    moved = sum(not np.array_equal(np.asarray(v), np.asarray(before[k]))
                for k, v in _tree_items(qat["params"]))
    # the first loss of 2 images, card against CPU, in f64: in f32 a conv sum
    # that differs in its last bit flips a rounding of the fake-quant graph
    # (the CPU alone moves this loss by 3.8% between 1 and 8 threads)
    first = [(steps[0][0][:2], steps[0][1][:2], None)]
    l_card, l_cpu = [], []
    Q.qat_finetune(name, NC, folded, quant, Batches(first), img_size=320, epochs=1,
                   device=dev, dtype=torch.float64, losses=l_card)
    Q.qat_finetune(name, NC, folded, quant,
                   Batches([(first[0][0].cpu(), first[0][1].cpu(), None)]), img_size=320,
                   epochs=1, device="cpu", dtype=torch.float64, losses=l_cpu)
    torch.set_grad_enabled(False)
    emit(phase="quant_qat", batch=8, img=320, losses=losses, leaves_moved=moved,
         leaves=len(list(_tree_items(folded["params"]))), first_loss_card=l_card[0],
         first_loss_cpu=l_cpu[0])
    check(len(losses) == 2 and all(np.isfinite(losses)), f"QAT losses {losses}")
    check(moved > 0, "QAT moved no parameter")
    check(abs(l_card[0] - l_cpu[0]) <= 1e-3 * abs(l_cpu[0]),
          f"QAT first loss card {l_card[0]} vs CPU {l_cpu[0]}")

    # ---- quant_cli: tools/quantize.run --eval on images held in memory
    sizes = [hw for hw, k in EVAL_SIZES.items() for _ in range(k)]
    sizes = [sizes[i] for i in np.random.default_rng(20).permutation(len(sizes))]
    src = eval_set(20, sizes)
    data = {"train": src, "val": src, "nc": NC, "names": [str(c) for c in range(NC)]}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "n.npck")
        with open(weights, "wb") as f:
            pickle.dump({"model": folded, "folded": True, "ema": None,
                         "meta": {"graph": name, "nc": NC}}, f, protocol=4)
        t0 = time.perf_counter()
        res = QT.run(QT.get_args_parser().parse_args(
            ["--weights", weights, "--data", "in-memory", "--img-size", str(IMG),
             "--batch-size", str(BATCH), "--calib-batches", "2", "--workers", "8", "--eval",
             "--device", str(dev)]),
            data_dict=data, dataset_cls=ArrayDataset)
        cli_s = time.perf_counter() - t0
        saved = os.path.exists(weights.replace(".npck", "_calib.npck"))
    emit(phase="quant_cli", images=len(sizes), seconds=cli_s, calibrated_ckpt=saved,
         ap={k: v.get("AP") for k, v in res.items()},
         ap50={k: v.get("AP50") for k, v in res.items()})
    check(list(res) == ["fp", "int8-sim", "int8-real"] and saved
          and all(np.isfinite(v["AP"]) for v in res.values()), f"quantize CLI: {res}")

    # ---- timing_quant: img/s (int8-real and bf16 as their graphs_check
    # timed them, with device busy and idle), then each site at bs32@640
    # (inputs of one forward)
    img_s, mean_ms, p50, p90 = route_timing(psim, batches)
    rate = {"int8_real": GRAPH_RATES["maf-yolo-n int8"]["graph"],
            "int8_sim": {"img_per_s": img_s, "batch_ms_mean": mean_ms, "p50_batch_ms": p50,
                         "p90_batch_ms": p90},
            "bf16": GRAPH_RATES["maf-yolo-n bf16"]["graph"]}
    recs, classes, total = time_int8_model(p8.model, x8)
    emit(phase="timing_quant", model=name, batch=BATCH, img=IMG, card=card, predict=rate,
         classes=classes, per_kernel=total,
         sites=[{k: r[k] for k in ("site", "class", "shape", "ldx", "cout", "act", "ms",
                                   "cold_ms", "bound_ms", "int_mm_ms") if k in r}
                for r in recs],
         note="ms: CUDA events around eager launches on one forward's inputs (warm: a "
              "small input stays in L2), cold_ms: on copies of each input taken in turn, "
              "none in L2; summed over the sites of a class; int_mm_ms: torch._int_mm on "
              "the dense sites' quantized operands (3x3 s2: unfolded to [M, 9C], the "
              "unfold not timed); cudnn_bf16_ms: no int8 conv exists in PyTorch on the "
              "card, so cuDNN's bf16 conv of the same shape, a yardstick of another function")
    return [
        {"name": kname, "route": "cuda", "source": f"mafyolo_tpu_torch/csrc/{kname}.cu",
         "replaces": "mafyolo_tpu/models/blocks.py:306-321", "launches": launches[kname],
         "max_abs_err": conv_err[kind], "ms": total[kind]["cold_ms"],
         "warm_ms": total[kind]["ms"], "plain_ms": total[kind]["plain_ms"],
         "bound_ms": total[kind]["bound_ms"], "bound_by": total[kind]["bound_by"],
         "library_ms": lib, "library_covers": covers}
        for kname, kind, lib, covers in (
            ("int8_conv", "dense", classes["1x1s1"]["int_mm_ms"],
             "torch._int_mm on the quantized operands of the 1x1 sites only (54 of the "
             "66 launches); the 3x3 s2 sites' is timing_quant's classes['3x3s2']"),
            ("int8_dw", "dw", None, "no int8 depthwise conv in PyTorch"))]


def sm_train_phase(dev):
    """Phase 22: MAF-YOLO-S and -M trained on the card. The dw_grad kernel
    against its plain version at every distinct DW site of S's and M's train
    graphs at B=2 (dw_grad_gate); S at bs16@640 and M at bs8@640 in bf16
    through make_train_step, the steps of SM_TRAIN (the dw_grad launches
    read around them: one a DW site a step; every loss finite; updates the
    apply steps), then the same steps again timed by CUDA events, with the
    peak memory of the first run; one f32 S step at bs2@160 on the card
    against the CPU (step_card_vs_cpu); S's EMA folded and served at
    bs32@640 through Evaler.predict, the fold checked on raw outputs
    (serve_ema). Timed too: dk a step by class of site (H, k) at each
    model's batch, the kernel beside aten's weight gradient and the bound.
    -> the dw_grad launches and the largest dk error."""
    import numpy as np
    import torch

    from mafyolo_tpu_torch.core.engine import Schedule
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import (cold_sets, dw_library, dw_site_inputs,
                                                dw_sites, images, in_turn)
    from mafyolo_tpu_torch.utils.timing import cuda_ms
    cl = torch.channels_last

    sites = {}
    for graph, _, _ in SM_TRAIN:
        sites[graph] = dw_sites(build_model(graph, nc=NC).to(dev).to(memory_format=cl), IMG, dev)
    cases = sorted(set().union(*map(set, sites.values())))
    dk_err = dw_grad_gate(dev, cases, phase="sm_dw_grad_check")
    emit(phase="sm_dw_grad_sites", cases=len(cases), max_abs_err=dk_err,
         **{f"{g[-1]}_sites": len(v) for g, v in sites.items()},
         **{f"{g[-1]}_distinct": len(set(v)) for g, v in sites.items()})

    cfg = Config.fromfile(os.path.join(HERE, "configs", "maf_yolo_n.py"))
    launches, ema = {}, None
    for graph, bs, plan in SM_TRAIN:
        sched = Schedule(cfg.solver, bs, 300, STEPS_PER_EPOCH)
        lrs = sched.lrs(0, 2)
        torch.manual_seed(0)
        model = build_model(graph, nc=NC).to(dev).to(memory_format=cl)
        state = init_train_state(model, weight_decay=sched.weight_decay, lr0=sched.lr0,
                                 momentum=cfg.solver["momentum"])
        step = make_train_step(num_classes=NC, img_size=IMG, dtype=torch.bfloat16)
        batches = [train_batch(300 + i, bs, IMG, dev) for i in range(len(plan))]

        def run():
            return [step(state, im, tg, lrs["lr_bnw"], lrs["lr_weight"], lrs["lr_bias"],
                         lrs["momentum"], do_apply, use_atss)
                    for (do_apply, use_atss), (im, tg) in zip(plan, batches)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        DG.dw_grad.launches = 0
        losses = [{k: float(v) for k, v in m.items()} for m in run()]
        torch.cuda.synchronize()
        launches[graph] = DG.dw_grad.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize()
        step_ms = t0.elapsed_time(t1) / len(plan)
        n_apply = sum(a for a, _ in plan)
        emit(phase="sm_train", model=graph, dtype="bf16", batch=bs, img=IMG, steps=len(plan),
             plan=[{"apply": a, "atss": u} for a, u in plan], dw_sites=len(sites[graph]),
             dw_grad_launches=launches[graph], updates=state.updates, losses=losses,
             peak_mem_gb=peak, step_ms_mean=step_ms, img_per_s=bs / (step_ms / 1e3),
             note="step_ms: CUDA events over a second run of the same steps; peak memory "
                  "of the first run")
        check(all(np.isfinite(v) for lo in losses for v in lo.values()),
              f"sm_train {graph}: non-finite loss {losses}")
        check(state.updates == 2 * n_apply, f"sm_train {graph}: updates {state.updates}")
        check(launches[graph] == len(sites[graph]) * len(plan),
              f"sm_train {graph}: dw_grad launches {launches[graph]} != "
              f"{len(sites[graph])} DW sites x {len(plan)} steps")
        if graph == "maf-yolo-s":
            ema = state_dict_to_train_variables(state.ema.state_dict())
        del model, state, step, batches
        torch.cuda.empty_cache()

        # dk a step by class of site (H, k) at this batch: the kernel and
        # aten's weight gradient on inputs taken in turn from enough copies
        # that none is in L2, as timing_train times N's
        per_class = {}
        for site in sorted(set(sites[graph])):
            c, h, _, k, pad, dil = site
            n = sites[graph].count(site)
            x, g = dw_site_inputs(site, bs, dev)
            sets = cold_sets((x, g))
            kernel_ms = cuda_ms(in_turn(lambda x, g: DG.dw_grad(x, g, k, pad, dil), sets), 20)
            library_ms = cuda_ms(in_turn(dw_library(x, k, pad, dil), sets), 20)
            cls = per_class.setdefault(f"h{h}k{k}", {"sites": 0, "kernel_ms": 0.0,
                                                     "library_ms": 0.0, "bound_ms": 0.0})
            cls["sites"] += n
            cls["kernel_ms"] += n * kernel_ms
            cls["library_ms"] += n * library_ms
            cls["bound_ms"] += n * bound(2 * x.numel() * 2 + c * k * k * 4,
                                         2 * k * k * x.numel(), "bf16")["bound_ms"]
            del x, g, sets
        emit(phase="sm_dk_per_class", model=graph, batch=bs, dtype="bf16",
             dk_kernel_ms_per_step=sum(v["kernel_ms"] for v in per_class.values()),
             dk_library_ms_per_step=sum(v["library_ms"] for v in per_class.values()),
             dk_bound_ms_per_step=sum(v["bound_ms"] for v in per_class.values()),
             per_class=per_class,
             note="CUDA events around eager calls, inputs not in the L2 cache")

    step_card_vs_cpu(dev, "maf-yolo-s", len(sites["maf-yolo-s"]), phase="sm_train_check")
    serve_ema(dev, "maf-yolo-s", ema, images(400, BATCH, IMG, IMG).to(dev),
              phase="sm_train_to_serve")
    return {"launches": launches, "dk_err": dk_err}


def bridge_phase(dev):
    """Phase 23: reference `.pt` checkpoints (utils/torch_bridge.py). For N
    and S: random train-form weights written in the reference's key layout
    (utils/sample.py:reference_state_dict) with torch.save, read back by
    load_checkpoint, and served at bs32@640 in bf16 through Evaler.predict;
    gate: every output bit-equal to the predict of the same weights read
    from a `.npck`, each predict launching the front-end kernel once and
    the NMS kernel. Then a Trainer built with --pretrained set to N's `.pt`
    (every parameter taken from it) takes one step (dw_grad once a DW
    site, a finite loss)."""
    import pickle
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch

    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                                state_dict_to_train_variables)
    from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import (ArrayDataset, dw_sites, images,
                                                reference_state_dict, train_set)

    tmp = tempfile.TemporaryDirectory()
    imgs = images(500, BATCH, IMG, IMG).to(dev)
    pts = {}
    for graph in ("maf-yolo-n", "maf-yolo-s"):
        specs = build_model(graph, nc=NC).specs
        variables = random_train_variables(specs, seed=11)
        sd = reference_state_dict(variables, specs)
        pts[graph] = os.path.join(tmp.name, f"{graph}.pt")
        torch.save({"model": sd}, pts[graph])
        npck = os.path.join(tmp.name, f"{graph}.npck")
        with open(npck, "wb") as f:
            pickle.dump({"model": variables, "ema": None, "meta": {"graph": graph, "nc": NC}}, f)
        outs, counts = {}, {}
        for tag, path in (("pt", pts[graph]), ("npck", npck)):
            ckpt = load_checkpoint(path)
            check(ckpt["meta"]["graph"] == graph and ckpt["meta"]["nc"] == NC,
                  f"bridge: {tag} read as {ckpt['meta']}")
            ev = Evaler(half=True, device=dev)
            ev.init_model(graph, eval_variables(ckpt), NC, folded=False)
            FE.frontend_forward.launches = G.greedy_nms.launches = 0
            outs[tag] = ev.predict(imgs)
            torch.cuda.synchronize()
            counts[tag] = {"frontend": FE.frontend_forward.launches,
                           "greedy_nms": G.greedy_nms.launches}
            del ev
        equal = {k: torch.equal(outs["pt"][k], outs["npck"][k]) for k in outs["npck"]}
        emit(phase="bridge", model=graph, reference_keys=len(sd), batch=BATCH, img=IMG,
             dtype="bf16", launches=counts, bit_equal=equal,
             dets_per_image_mean=float(outs["pt"]["valid"].sum(1).float().mean().item()))
        check(all(equal.values()), f"bridge {graph}: .pt predict differs from .npck: {equal}")
        check(all(c["frontend"] == 1 and c["greedy_nms"] >= 1 for c in counts.values()),
              f"bridge {graph}: front-end or NMS kernel not launched: {counts}")

    cfg = Config.fromfile(os.path.join(HERE, "configs", "maf_yolo_n.py"))
    args = SimpleNamespace(img_size=IMG, batch_size=BATCH, epochs=1, workers=8, seed=0,
                           save_dir=os.path.join(tmp.name, "run"), tensorboard=False,
                           device_aug=True, stop_aug_last_n_epoch=0,
                           pretrained=pts["maf-yolo-n"])
    tr = Trainer(args, cfg, {"train": train_set(41, 8), "nc": NC}, device=dev,
                 dataset_cls=ArrayDataset)
    want = load_checkpoint(pts["maf-yolo-n"])["model"]["params"]
    got = state_dict_to_train_variables(dict(tr.state.model.named_parameters()))["params"]
    got = dict(_tree_items(got))
    same = all(np.array_equal(got[k], w) for k, w in _tree_items(want))
    n_sites = len(dw_sites(tr.state.model, IMG, dev))
    DG.dw_grad.launches = 0
    met = tr._train_steps(0, [train_batch(501, BATCH, IMG, dev)])[0]
    torch.cuda.synchronize()
    loss = {k: float(v) for k, v in met.items()}
    emit(phase="bridge_pretrained", model="maf-yolo-n", params_from_pt=same,
         dw_grad_launches=DG.dw_grad.launches, loss=loss)
    check(same, "bridge: the Trainer's params are not the .pt's")
    check(all(np.isfinite(v) for v in loss.values()), f"bridge: non-finite loss {loss}")
    check(DG.dw_grad.launches == n_sites, f"bridge: dw_grad launches {DG.dw_grad.launches}")
    tmp.cleanup()


def ddp_phase(dev, card):
    """Phase 24: data parallel (parallel/ddp.py). Two ranks, spawned, on the
    one card with gloo over CUDA tensors (NCCL refuses two ranks on one
    GPU), each DDP_BATCH images of the global batch's DDP_WORLD x DDP_BATCH
    at DDP_IMG, N in f32 from its init (zero preds), tools/ddp_check.py's
    run, against one process on the whole batch (itself spawned, as the
    ranks are). Gates: the two ranks' states equal bit for bit after the
    plan (apply with ATSS, accumulate-only, apply with TAL; cuDNN
    deterministic, no augmentation); within
    tests/test_multidev_equivalence.py's tolerances, elementwise: loss
    components, params, EMA and BN running statistics (model and EMA) rtol
    1e-5 / atol 1e-6, momentum rtol 1e-4 / atol 2e-5 (at 320 px the f32
    step is well enough conditioned for them; tests/test_torch_ddp.py holds
    them at 64 px on the CPU in f64, augmented too); dw_grad launched once
    a DW site a step on each rank; one augmentation under the --device-aug
    recipe (mosaic and dynamic mixup: each rank gathers the global batch
    and warps its rows and their partners) equal on each rank, bit for bit,
    to the one process's rows. The plan with that augmentation is reported
    (aug_plan_err_over_tolerance), not gated: in f32 TAL's targets turn on
    near-ties that rounding decides (tools/ddp_check.py). Then the train CLI
    with --device-count 1 (its one rank in this process, NCCL, world size
    1) trains an epoch of 2 steps at bs8@320 with --device-aug on 16 images
    held in memory: its dw_grad launches and checkpoint. Step ms by CUDA
    events for each, gloo's labelled as two ranks on one card: not a
    scaling figure (tools/ddp_check.py reads that across cards)."""
    import tempfile

    import numpy as np
    import torch

    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.parallel import ddp
    from mafyolo_tpu_torch.tools import ddp_check as DC
    from mafyolo_tpu_torch.tools import train as train_cli
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, dw_sites, train_set

    torch.manual_seed(0)
    model = build_model("maf-yolo-n", nc=NC)
    variables = state_dict_to_train_variables(model.state_dict())
    n_sites = len(dw_sites(model.to(dev).to(memory_format=torch.channels_last), DDP_IMG, dev))
    del model
    imgs, targets = (t.cpu() for t in train_batch(600, DDP_WORLD * DDP_BATCH, DDP_IMG, dev))
    t_spawn = time.perf_counter()
    ranks = DC.spawn_runs(DDP_WORLD, "gloo", variables, imgs, targets, DDP_TIMED_STEPS)
    spawn_s = time.perf_counter() - t_spawn
    one = DC.spawn_runs(1, "gloo", variables, imgs, targets, DDP_TIMED_STEPS)[0]

    same = all(np.array_equal(a, b) for tree in ("model", "ema", "mom")
               for (_, a), (_, b) in zip(_tree_items(ranks[0][tree]), _tree_items(ranks[1][tree])))
    errs, worst = DC.errors(ranks[0], one)
    aug_same = DC.aug_equal(ranks, one)
    aug_errs, _ = DC.errors(ranks[0]["aug_plan"], one["aug_plan"])
    emit(phase="ddp", model="maf-yolo-n", dtype="f32", backend="gloo", ranks=DDP_WORLD,
         rank_batch=DDP_BATCH, img=DDP_IMG, plan=[{"apply": a, "atss": u} for a, u in DC.PLAN],
         device_aug=DC.AUG, ranks_bit_equal=same, aug_rows_bit_equal=aug_same,
         err_over_tolerance=errs, worst_leaf=worst, aug_plan_err_over_tolerance=aug_errs,
         losses={"rank0": [m["loss"] for m in ranks[0]["metrics"]],
                 "one_process": [m["loss"] for m in one["metrics"]]},
         dw_grad_launches=[r["launches"] for r in ranks], one_process_launches=one["launches"],
         step_ms_two_ranks_gloo_one_card=[r["step_ms"] for r in ranks],
         augment_ms_two_ranks_gloo_one_card=[r["augment_ms"] for r in ranks],
         step_ms_one_process=one["step_ms"], augment_ms_one_process=one["augment_ms"],
         spawn_and_run_s=spawn_s, card=card,
         note="two gloo ranks share one card: their step ms is not a scaling figure; "
              "err_over_tolerance: the largest error over its tolerance, gated at 1")
    check(same, "ddp: the two ranks' states differ")
    check(aug_same, "ddp: a rank's augmented rows differ from the one process's")
    for key, v in errs.items():
        check(v <= 1.0, f"ddp: two ranks against one process, {key} at {v} x its tolerance")
    check(all(r["launches"] == n_sites * len(DC.PLAN) for r in ranks),
          f"ddp: dw_grad launches {[r['launches'] for r in ranks]} != {n_sites} x "
          f"{len(DC.PLAN)}")
    check(all(r["updates"] == 2 for r in ranks), "ddp: updates")

    # the train CLI's entry, one rank, NCCL
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "runs")
    args = train_cli.get_args_parser().parse_args(
        ["--conf", os.path.join(HERE, "configs", "maf_yolo_n.py"), "--img-size", str(DDP_IMG),
         "--batch-size", "8", "--epochs", "1", "--workers", "4", "--output-dir", out,
         "--device-count", "1", "--device-aug", "--stop-aug-last-n-epoch", "0",
         "--device", dev.type])
    DG.dw_grad.launches = 0
    t_cli = time.perf_counter()
    train_cli.main(args, data_dict={"train": train_set(42, 16, size=DDP_IMG), "nc": NC},
                   dataset_cls=ArrayDataset)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t_cli
    cli_launches = DG.dw_grad.launches
    ckpt = load_checkpoint(os.path.join(out, "exp", "last_ckpt.npck"))
    finite = all(np.isfinite(v).all() for _, v in _tree_items(ckpt["model"]))
    emit(phase="ddp_cli", backend=ddp.default_backend(dev), world_size=1, batch=8, img=DDP_IMG, steps=2,
         dw_grad_launches=cli_launches, wall_s=cli_s, checkpoint_epoch=ckpt["epoch"],
         checkpoint_finite=finite, still_in_group=ddp.active(),
         note="wall_s: the CLI call, Trainer build, 2 steps, save and strip included")
    check(cli_launches == 2 * n_sites, f"ddp_cli: dw_grad launches {cli_launches}")
    check(finite and ckpt["epoch"] == 0 and ckpt["ema"] is None,
          "ddp_cli: bad checkpoint")
    check(not ddp.active(), "ddp_cli: the process group outlived the run")
    tmp.cleanup()


def simota_graph():
    """MAF-YOLO-N's graph with its three head rows as Head_simota, each as
    wide as the Head_DepthUni it replaces, reg_max 0."""
    import copy

    from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
    g = copy.deepcopy(MODEL_ZOO["maf-yolo-n"])
    g["effidehead"] = [[f, n, "Head_simota", [args[0], 0]] if m == "Head_DepthUni"
                       else [f, n, m, args] for f, n, m, args in g["effidehead"]]
    return g


def recipes_phase(dev, card):
    """Phase 25: MAF-YOLO-N trained under each training recipe on the card.
    RECIPES: giou (the configs' own), diou, ciou, siou, wiou (Wise-IoU, its
    running mean in the state), distill (--distill with --distill-feat, the
    teacher N from another seed saved as .npck and read by the Trainer's
    path), simota (N's graph with Head_simota heads) and repopt
    (training_mode='repopt', scales from random_scales_like pickled and read
    back by load_scales; the kernels re-initialized). Per recipe, a Trainer
    at bs32@640 bf16 from its init, two steps on batches made on the card
    (accumulate-only, then apply; TAL, epoch RECIPE_EPOCH), the dw_grad
    launches read around them; gates: every loss finite, dw_grad launched
    once a DW site a step (SimOTA's heads have none), one update, Wise-IoU's
    mean moved from 1 by its recipe only; then the same two steps again,
    timed by CUDA events, beside giou's. Each recipe's f32 step at bs2@160
    on the card against the CPU (step_card_vs_cpu). Then two Trainers
    through an epoch of RECIPE_IMAGES images held in memory with
    --device-aug, evaluated by run_eval on the EMA (the front-end and NMS
    launches read around it): --distill, and repopt with iou_type 'wiou'
    from --pretrained random plain weights (the distillation loss knows no
    Wise-IoU and raises, as JAX's does). Gates: the evals launch the
    front-end once a batch and NMS at least as often; the repopt run's
    checkpoint holds a Wise-IoU mean other than 1, and a Trainer resumed
    from it starts from it bit for bit; its EMA folded and served by
    Evaler.predict at bs32@640 (one front-end launch), and in f32 on the
    card against the CPU on 2 images, >= 95% of the CPU's detections above
    0.1 matched. Last, SimOTA's decode (decode_simota_eval) of the simota
    Trainer's model on a bs32 batch through batched_nms, the NMS kernel's
    launches counted, its boxes, scores, classes and valid mask equal to the
    plain greedy NMS's on a CPU copy of the same predictions. -> the
    launches of the phase, per kernel."""
    import pickle
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch

    from mafyolo_tpu_torch.core.engine import Schedule, Trainer
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.detect import decode_simota_eval
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops.nms import batched_nms
    from mafyolo_tpu_torch.solver import repopt as R
    from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                                state_dict_to_train_variables)
    from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, dw_sites, eval_set, images, train_set

    tmp = tempfile.TemporaryDirectory()
    total = {"dw_grad": 0, "frontend": 0, "greedy_nms": 0, "dw_conv": 0}

    def launches():
        return {"dw_grad": DG.dw_grad.launches, "frontend": FE.frontend_forward.launches,
                "greedy_nms": G.greedy_nms.launches, "dw_conv": DD.dw_conv.launches}

    def counted(fn):
        """fn() with the launches it makes added to the phase's."""
        before = launches()
        out = fn()
        torch.cuda.synchronize()
        for k, v in launches().items():
            total[k] += v - before[k]
        return out, {k: v - before[k] for k, v in launches().items()}

    # the teacher: N from another seed, as a checkpoint the Trainer reads
    teacher_path = os.path.join(tmp.name, "teacher.npck")
    with open(teacher_path, "wb") as f:
        pickle.dump({"model": random_train_variables(build_model("maf-yolo-n", nc=NC).specs, 23),
                     "ema": None, "meta": {"graph": "maf-yolo-n", "nc": NC}}, f)
    # repopt's scales: random_scales_like on the plain graph, pickled
    scales_path = os.path.join(tmp.name, "scales.pkl")
    with open(scales_path, "wb") as f:
        pickle.dump(R.random_scales_like(build_model("maf-yolo-n", nc=NC, plain_rep=True),
                                         np.random.default_rng(0)), f)
    sim = simota_graph()
    recipes = {
        "giou": {}, "diou": {"iou_type": "diou"}, "ciou": {"iou_type": "ciou"},
        "siou": {"iou_type": "siou"}, "wiou": {"iou_type": "wiou"},
        "distill": {"loss_type": "distill"},
        "simota": {"loss_type": "simota", "iou_type": "ciou", "graph": sim},
        "repopt": {"training_mode": "repopt"},
    }

    def config(recipe):
        cfg = Config.fromfile(os.path.join(HERE, "configs", "maf_yolo_n.py"))
        if "iou_type" in recipe:
            cfg.model.head.iou_type = recipe["iou_type"]
        if "graph" in recipe:
            cfg.model.graph = recipe["graph"]
        if recipe.get("training_mode") == "repopt":
            cfg.training_mode = "repopt"
            cfg.model.scales = scales_path
        return cfg

    def trainer(name, recipe, save, data, **kw):
        args = SimpleNamespace(img_size=IMG, batch_size=BATCH, epochs=300, workers=8, seed=0,
                               save_dir=os.path.join(tmp.name, save), tensorboard=False,
                               simota=recipe.get("loss_type") == "simota",
                               distill=recipe.get("loss_type") == "distill",
                               teacher_model_path=teacher_path, distill_feat=True, **kw)
        return Trainer(args, config(recipe), data, device=dev, dataset_cls=ArrayDataset)

    batches = [train_batch(700 + i, BATCH, IMG, dev) for i in range(2)]
    rows, step_ms, sim_tr = {}, {}, None
    for name, recipe in recipes.items():
        torch.manual_seed(0)
        tr = trainer(name, recipe, name, {"train": train_set(43, 8, size=IMG), "nc": NC})
        tr.schedule = Schedule(tr.cfg.solver, BATCH, 300, STEPS_PER_EPOCH)
        # the first step accumulates, the second applies (accumulate 2 at bs32)
        accumulate = tr.schedule.lrs(0, RECIPE_EPOCH)["accumulate"]
        last_opt = STEPS_PER_EPOCH * RECIPE_EPOCH + 1 - accumulate
        tr.schedule.last_opt_step = last_opt
        n_sites = len(dw_sites(tr.state.model, IMG, dev))
        metrics, n = counted(lambda: tr._train_steps(RECIPE_EPOCH, batches))
        losses = [{k: float(v) for k, v in m.items()} for m in metrics]
        mean = float(tr.state.wiou_mean)
        updates = tr.state.updates
        # the same two steps again, timed
        tr.schedule.last_opt_step = last_opt
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        tr._train_steps(RECIPE_EPOCH, batches)
        t1.record()
        torch.cuda.synchronize()
        step_ms[name] = t0.elapsed_time(t1) / 2
        rows[name] = {"dw_sites": n_sites, "dw_grad_launches": n["dw_grad"], "losses": losses,
                      "updates": updates, "wiou_mean": mean, "step_ms": step_ms[name],
                      "loss_type": tr.loss_type, "grad_masks": len(tr.grad_mask or {})}
        check(all(np.isfinite(v) for lo in losses for v in lo.values()),
              f"recipes {name}: non-finite loss {losses}")
        check(n["dw_grad"] == 2 * n_sites and n_sites > 0,
              f"recipes {name}: dw_grad launches {n['dw_grad']} != 2 x {n_sites} DW sites")
        check(updates == 1, f"recipes {name}: {updates} updates after accumulate + apply")
        check((mean != 1.0) == (name == "wiou") and np.isfinite(mean),
              f"recipes {name}: Wise-IoU mean {mean}")
        if name == "simota":
            sim_tr = tr
        else:
            del tr
        torch.cuda.empty_cache()
    emit(phase="recipes", model="maf-yolo-n", dtype="bf16", batch=BATCH, img=IMG,
         epoch=RECIPE_EPOCH, card=card, recipes=rows, step_ms=step_ms,
         step_ms_over_giou={k: v / step_ms["giou"] for k, v in step_ms.items()},
         note="two steps (accumulate-only, apply) each from the recipe's init; step_ms: "
              "CUDA events over the same two steps run again, a record and not a claim")
    check(rows["simota"]["dw_sites"] < rows["giou"]["dw_sites"] == rows["repopt"]["dw_sites"],
          f"recipes: DW sites {[(k, r['dw_sites']) for k, r in rows.items()]}")
    check(rows["repopt"]["grad_masks"] == 5, "recipes: repopt masks")

    # each recipe's f32 step, card against CPU
    for name, recipe in recipes.items():
        if name == "giou":
            continue      # phase 16
        graph = recipe.get("graph", "maf-yolo-n")
        step_card_vs_cpu(dev, graph, rows[name]["dw_sites"], phase=f"recipes_check_{name}",
                         recipe=recipe)

    # SimOTA's decode: decode_simota_eval -> batched_nms, bs32
    model = sim_tr.state.model.eval()
    x = images(701, BATCH, IMG, IMG).to(dev)
    with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16):
        outs = model(x.flip(-1).float() / 255.0)
    pred = decode_simota_eval(outs, model.strides)
    # obj x cls sits near the prior's 1e-4 two steps from the init
    out, n = counted(lambda: batched_nms(pred, conf_thres=1e-5))
    # the same candidates through the plain greedy NMS on the CPU: the
    # kernel reproduces the plain IoU bit for bit, so every output is equal
    want = batched_nms(pred.cpu(), conf_thres=1e-5)
    differ = {k: int((out[k].cpu() != want[k]).any(-1).sum().item()) if out[k].dim() == 3
              else int((out[k].cpu() != want[k]).sum().item()) for k in want}
    emit(phase="recipes_simota_decode", batch=BATCH, img=IMG, anchors=pred.shape[1],
         launches=n, dets_per_image_mean=float(out["valid"].sum(1).float().mean().item()),
         max_conf=float((pred[..., 5:] * pred[..., 4:5]).max().item()),
         differ_from_cpu=differ)
    check(not any(differ.values()),
          f"recipes: simota decode: the card's NMS differs from the CPU's plain one: {differ}")
    check(pred.shape == (BATCH, sum((IMG // s) ** 2 for s in model.strides), 5 + NC)
          and bool(torch.isfinite(pred).all()), "recipes: simota decode")
    check(n["greedy_nms"] >= 1 and out["boxes"].shape == (BATCH, 300, 4)
          and bool(out["valid"].any()) and bool(torch.isfinite(out["boxes"]).all()),
          f"recipes: simota decode: NMS launches {n}, {int(out['valid'].sum())} detections")
    del sim_tr, model, outs, pred
    torch.cuda.empty_cache()

    # two Trainers end to end: --distill, and repopt with Wise-IoU
    sizes = [hw for hw, k in EVAL_SIZES.items() for _ in range(k)]
    data = {"train": train_set(44, RECIPE_IMAGES, size=IMG), "val": eval_set(21, sizes),
            "nc": NC, "names": [str(c) for c in range(NC)]}
    eval_batches = -(-len(sizes) // min(2 * BATCH, 64))
    pre = os.path.join(tmp.name, "plain.npck")
    with open(pre, "wb") as f:
        pickle.dump({"model": random_train_variables(build_model(
            "maf-yolo-n", nc=NC, plain_rep=True).specs, 24, plain_rep=True)}, f)
    epochs = {}
    for name, recipe, kw in (("distill", recipes["distill"], {}),
                             ("repopt_wiou", dict(recipes["repopt"], iou_type="wiou"),
                              {"pretrained": pre})):
        tr = trainer(name, recipe, f"epoch_{name}", data, device_aug=True,
                     stop_aug_last_n_epoch=0, **kw)
        tr.epochs = 1                        # epoch 0 is the last: it evaluates
        before = launches()
        (_, n_train) = counted(lambda: tr.train_one_epoch(0))
        metrics, n_eval = counted(lambda: tr.eval_and_save(0))
        ckpt = load_checkpoint(os.path.join(tmp.name, f"epoch_{name}", "last_ckpt.npck"))
        epochs[name] = {"train_launches": n_train, "eval_launches": n_eval,
                        "metrics": metrics, "updates": tr.state.updates,
                        "wiou_mean": ckpt["wiou_mean"]}
        check(metrics is not None and all(np.isfinite(v) for v in metrics.values()),
              f"recipes trainer {name}: eval {metrics}")
        check(n_eval["frontend"] == eval_batches and n_eval["greedy_nms"] >= eval_batches,
              f"recipes trainer {name}: eval launches {n_eval} over {eval_batches} batches")
        check(n_train["dw_grad"] > 0 and tr.state.updates > 0,
              f"recipes trainer {name}: {n_train}, updates {tr.state.updates}")
        if name == "distill":
            check(ckpt["wiou_mean"] == 1.0, "recipes trainer distill: Wise-IoU mean moved")
            del tr
            continue
        check(ckpt["wiou_mean"] != 1.0, f"recipes trainer: Wise-IoU mean {ckpt['wiou_mean']}")
        again = trainer(name, recipe, "resumed", data, device_aug=True,
                        stop_aug_last_n_epoch=0,
                        resume=os.path.join(tmp.name, f"epoch_{name}", "last_ckpt.npck"))
        resumed = bool(torch.equal(again.state.wiou_mean, tr.state.wiou_mean))
        epochs[name]["resumed_bit_equal"] = resumed
        check(resumed and float(again.state.wiou_mean) == ckpt["wiou_mean"],
              "recipes trainer: the resumed Wise-IoU mean differs")
        ema = state_dict_to_train_variables(tr.state.ema.state_dict())
        del tr, again

    # the repopt EMA folded and served; f32 card against the CPU
    ev = Evaler(half=True, device=dev)
    ev.init_model("maf-yolo-n", ema, NC, folded=False)
    served, n = counted(lambda: ev.predict(images(702, BATCH, IMG, IMG).to(dev)))
    gpu32, cpu32 = Evaler(half=False, device=dev), Evaler(half=False, device="cpu")
    gpu32.init_model("maf-yolo-n", ema, NC, folded=False)
    cpu32.init_model("maf-yolo-n", ema, NC, folded=False)
    two = images(703, 2, IMG, IMG)
    card32, _ = counted(lambda: {k: v.cpu() for k, v in gpu32.predict(two.to(dev)).items()})
    n_ref, matched = match(cpu32.predict(two), card32, 0.1)
    emit(phase="recipes_trainers", card=card, images=RECIPE_IMAGES, epochs=epochs,
         repopt_serve_launches=n,
         repopt_dets_per_image_mean=float(served["valid"].sum(1).float().mean().item()),
         repopt_f32_cpu_dets_above_0p1=n_ref, repopt_f32_matched=matched)
    check(n["frontend"] == 1 and n["greedy_nms"] >= 1,
          f"recipes: the repopt EMA's predict launches {n}")
    check(n_ref >= 10 and matched / n_ref >= 0.95,
          f"recipes: repopt EMA card vs CPU: {matched}/{n_ref} detections matched")
    tmp.cleanup()
    return total


# office: the YOLOv6 office graphs (models/office.py, OFFICE_CONFIGS) at
# full width. Their random deploy weights take the gain that keeps each
# graph's activations image-dependent and finite (random_deploy): N's
# RepBlocks keep 1.5, M's alpha-weighted BottleRep residuals grow faster,
# L's SiLU ConvWrappers faster still.
OFFICE_GAIN = {"yolov6n-office": 1.5, "yolov6m-office": 1.2, "yolov6l-office": 1.1}
OFFICE_BATCHES = 4          # bs32@640 batches of each office predict
OFFICE_TRAIN_IMAGES = 40    # the office Trainer's epoch: batches of 32 and 8
OFFICE_M_TRAIN_BATCH = 8
# The least share of the f32 predict's detections that the bf16 predict of
# the same bs32 batch matches (match()'s criterion), per office graph: 0.6 x
# the first card run's, 376 / 1148, 707 / 1232 and 368 / 723 (PERF.md §6,
# the office entry; NVIDIA H100 80GB HBM3, 700.00 W), for the reason BF16_SHARE_FLOOR
# gives.
OFFICE_SHARE_FLOOR = {"yolov6n-office": 0.196, "yolov6m-office": 0.344, "yolov6l-office": 0.305}


def model_layers0_1(model, dtype):
    """The deploy model's own layers 0-1 on uint8 BGR NHWC images, with the
    flip, the cast and /255 of Evaler.forward's other branch."""
    net = model.net

    def run(imgs):
        x = (imgs.flip(-1).to(dtype) / 255.0).permute(0, 3, 1, 2)
        return net.layer1(net.layer0(x))
    return run


def office_config(name):
    """configs/maf_yolo_n.py's solver and augmentation around an office
    graph's model section (its head's loss settings, giou with DFL, too)."""
    from mafyolo_tpu_torch.models.office import OFFICE_CONFIGS
    from mafyolo_tpu_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(HERE, "configs", "maf_yolo_n.py"))
    model_cfg, mode = OFFICE_CONFIGS[name]
    cfg.model = dict(model_cfg, head=dict(cfg.model.head.to_dict(), **model_cfg["head"]))
    cfg.training_mode = mode
    return cfg


def office_phase(dev, card):
    """Phase 26: the YOLOv6 office graphs (EfficientRep / CSPBep + RepPAN +
    EffiDeHead) served and trained on the card.

    Serve: N, M and L at full width on random_deploy weights, bf16,
    OFFICE_BATCHES batches of bs32 uint8 @640 through Evaler.predict, the
    front-end and NMS launches read around that run: N and M take the
    front-end's layers-0-1 mode (one launch a predict), L its own layers
    (layer 0 is a ConvWrapper: no launch); NMS at least once a predict.
    Then, on the first batch: the layers-0-1 kernel against its plain
    version (bf16 within the JAX kernel tests' 0.05 and mean < 0.01, f32
    within 1e-3, the errors printed) and the f32 kernel against the f32
    model's own layers 0-1 (1e-3); the f32 card predict against the CPU's
    on 2 images (>= 95% of the CPU's detections above 0.1 matched); the
    bf16 predict against the f32 one (OFFICE_SHARE_FLOOR); img/s, p50, the
    stage split, and the kernel's ms beside its plain version, the model's
    own layers 0-1 (bf16 cuDNN) and its bound.

    Train: office N through the Trainer with --device-aug, bs32@640 bf16 on
    OFFICE_TRAIN_IMAGES images held in memory, for one epoch that ends in
    an eval (rect batches through the layers-0-1 route and the NMS kernel,
    one front-end launch a batch, no dw_grad launch anywhere: the office
    graphs have no depthwise conv); its checkpoint's meta.graph is the
    office dict and a Trainer resumed from it holds the same state bit for
    bit; the EMA folded and served (serve_ema); one step of N on the card
    against the CPU (step_card_vs_cpu), held in f64 and recorded in f32
    (office_train's comment says why); one M step at bs8@640 bf16
    with its peak memory and time. -> {"kernel": the layers-0-1 entry of
    the kernels line, "launches": the phase's launches by kernel}."""
    import torch

    from mafyolo_tpu_torch.models.office import office_config_graph
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops.nms import fused_decode_nms
    from mafyolo_tpu_torch.utils.sample import evaler, images, random_deploy
    from mafyolo_tpu_torch.utils.timing import cuda_ms

    def launches():
        return {"dw_grad": DG.dw_grad.launches, "frontend": FE.frontend_forward.launches,
                "greedy_nms": G.greedy_nms.launches}

    total = {"dw_grad": 0, "frontend": 0, "greedy_nms": 0}
    shares, timing, errs = {}, {}, {}
    for name in ("yolov6n-office", "yolov6m-office", "yolov6l-office"):
        graph = office_config_graph(name)
        folded, over = random_deploy(graph, dev, OFFICE_GAIN[name])
        ev = evaler(graph, folded, True, dev)
        fe = ev.fe_skip == 1
        check(ev.fe_skip == (1 if name != "yolov6l-office" else -1),
              f"office {name}: front-end route {ev.fe_skip}")
        batches = [images(800 + i, BATCH).to(dev) for i in range(OFFICE_BATCHES)]
        torch.cuda.synchronize()
        DG.dw_grad.launches = FE.frontend_forward.launches = G.greedy_nms.launches = 0
        outs = [ev.predict(bt) for bt in batches]
        torch.cuda.synchronize()
        n = launches()
        for k, v in n.items():
            total[k] += v
        emit(phase="office_serve", model=name, dtype="bf16", batch=BATCH, img=IMG,
             batches=OFFICE_BATCHES, fe_skip=ev.fe_skip, launches=n,
             dets_per_image_mean=float(torch.cat([o["valid"].sum(1) for o in outs])
                                       .float().mean().item()))
        check(n["frontend"] == (OFFICE_BATCHES if fe else 0) and n["greedy_nms"] >= OFFICE_BATCHES
              and n["dw_grad"] == 0, f"office {name}: launches {n}")
        check_dets(outs, BATCH, f"office {name}")

        x = batches[0]
        ev32 = evaler(graph, folded, False, dev)
        rec = {}
        if fe:
            fw = ev.fe_weights
            want = FE.frontend_plain(x, fw)
            got32 = FE.frontend_forward(x, fw, torch.float32)
            e32, e16, m16 = kernel_vs_plain(got32, FE.frontend_forward(x, fw, torch.bfloat16),
                                            want, f"office {name} layers 0-1")
            own = model_layers0_1(ev32.model, torch.float32)(x).permute(0, 2, 3, 1)
            e_own = (got32 - own).abs().max().item()
            check(torch.allclose(got32, own, atol=1e-3, rtol=1e-3),
                  f"office {name}: layers-0-1 kernel against the model's own layers: {e_own}")
            errs[name] = e16
            rec = {"max_abs_err_f32": e32, "max_abs_err_bf16": e16, "mean_abs_err_bf16": m16,
                   "max_abs_err_f32_vs_model_layers0_1": e_own, "out_std": want.std().item(),
                   "bf16_plan": dict(zip(("tile_h", "tile_w", "smem_bytes", "threads"),
                                         FE.frontend_plan(fw))),
                   "f32_plan": dict(zip(("tile_h", "tile_w", "smem_bytes", "threads"),
                                        FE.frontend_plan(fw, torch.float32)))}
            del want, got32, own
        two = images(813, 2)
        n_cpu, m_cpu = match(evaler(graph, folded, False, "cpu").predict(two),
                             on_cpu(ev32.predict(two.to(dev))), 0.1)
        emit(phase="office_check", model=name, card=card, cpu_f32_dets_above_0p1=n_cpu,
             cpu_matched=m_cpu, cpu_fraction=m_cpu / max(n_cpu, 1), **rec)
        check(n_cpu >= 10 and m_cpu / n_cpu >= 0.95,
              f"office {name}: card f32 vs CPU {m_cpu}/{n_cpu} detections matched")
        shares[name] = bf16_vs_f32(f"{name}", ev32.predict(x), outs[0], ev32.forward(x),
                                   ev.forward(x))["share"]
        del ev32
        graphs_check(f"{name} bf16", card, ev.graphs, *evaler_routes(ev), batches, over)

        img_s, e2e, p50, p90 = graph_times(f"{name} bf16")
        stage = {}
        if fe:
            y = FE.frontend_forward(x, fw, torch.bfloat16)
            stage = {"frontend_ms": cuda_ms(lambda: FE.frontend_forward(x, fw, torch.bfloat16),
                                            10),
                     "frontend_f32_ms": cuda_ms(lambda: FE.frontend_forward(x, fw), 5),
                     "frontend_plain_ms": cuda_ms(
                         lambda: FE.frontend_plain(x, fw, torch.bfloat16), 5),
                     "model_layers0_1_ms": cuda_ms(
                         lambda: model_layers0_1(ev.model, torch.bfloat16)(x), 10),
                     "layers2_26_ms": cuda_ms(lambda: ev.model(y), 10),
                     **frontend_bound(fw.cfg, BATCH, IMG, IMG)}
            heads = ev.model(y)
            del y
        else:
            stage = {"model_ms": cuda_ms(lambda: ev.forward(x), 10)}
            heads = ev.forward(x)
        stage["decode_nms_ms"] = cuda_ms(lambda: fused_decode_nms(heads), 10)
        timing[name] = stage
        emit(phase="office_timing", model=name, card=card, dtype="bf16", batch=BATCH, img=IMG,
             img_per_s=img_s, batch_ms_mean=e2e, p50_batch_ms=p50, p90_batch_ms=p90, **stage)
        del ev, batches, outs, heads
        torch.cuda.empty_cache()
    emit(phase="office_bf16_vs_f32_shares", shares=shares, floors=OFFICE_SHARE_FLOOR)
    for key, floor in OFFICE_SHARE_FLOOR.items():
        check(shares[key] >= floor, f"office bf16 against f32, {key}: {shares[key]} < {floor}")

    with torch.enable_grad():
        office_train(dev, card, total)
    t_n = timing["yolov6n-office"]
    kernel = {"name": "frontend_layers01", "route": "cuda",
              "source": "mafyolo_tpu_torch/csrc/frontend.cu",
              "replaces": "mafyolo_tpu/ops/frontend_pallas.py:467 (fuse_l2=False)",
              "launches": total["frontend"], "max_abs_err": max(errs.values()),
              "ms": t_n["frontend_ms"], "plain_ms": t_n["frontend_plain_ms"],
              "bound_ms": t_n["bound_ms"], "bound_by": t_n["bound_by"],
              "library_ms": t_n["model_layers0_1_ms"]}
    emit(phase="office_launches", launches=total)
    return {"kernel": kernel, "launches": total}


def office_train(dev, card, total):
    """office_phase's train half (its docstring lists the gates); adds the
    launches of its main path to `total`."""
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch

    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.office import office_config_graph
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, eval_set, images, train_set
    from mafyolo_tpu_torch.utils.timing import cuda_ms

    def launches():
        return {"dw_grad": DG.dw_grad.launches, "frontend": FE.frontend_forward.launches,
                "greedy_nms": G.greedy_nms.launches}

    # ---- office N through the Trainer, then resume, serve the EMA
    name = "yolov6n-office"
    cfg = office_config(name)
    data = {"train": train_set(50, OFFICE_TRAIN_IMAGES, size=IMG),
            "val": eval_set(51, [(IMG, IMG)] * 8 + [(IMG * 3 // 4, IMG)] * 8), "nc": NC,
            "names": [str(c) for c in range(NC)]}
    eval_batches = -(-len(data["val"]["images"]) // min(2 * BATCH, 64))
    tmp = tempfile.TemporaryDirectory()

    def make(save_dir, **kw):
        args = SimpleNamespace(img_size=IMG, batch_size=BATCH, epochs=2, workers=8, seed=0,
                               save_dir=save_dir, device_aug=True, stop_aug_last_n_epoch=0,
                               eval_interval=1, tensorboard=False, **kw)
        return Trainer(args, cfg, data, device=dev, dataset_cls=ArrayDataset)

    a = make(os.path.join(tmp.name, "a"))
    graph = office_config_graph(name)
    check(a.graph == graph and a.max_stepnum == -(-OFFICE_TRAIN_IMAGES // BATCH),
          f"office trainer: {a.max_stepnum} steps")
    DG.dw_grad.launches = FE.frontend_forward.launches = G.greedy_nms.launches = 0
    t0 = time.perf_counter()
    running = a.train_one_epoch(0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    mid = launches()
    metrics = a.eval_and_save(0)
    torch.cuda.synchronize()
    after = launches()
    ev_n = {k: after[k] - mid[k] for k in after}
    for k, v in after.items():
        total[k] += v
    ckpt = load_checkpoint(os.path.join(tmp.name, "a", "last_ckpt.npck"))
    snap = {"model": a.state.model.state_dict(), "ema": a.state.ema.state_dict(),
            "mom": a._momentum()}
    b = make(os.path.join(tmp.name, "b"), resume=os.path.join(tmp.name, "a", "last_ckpt.npck"))
    diff = [k for k, v in b.state.model.state_dict().items() if not torch.equal(v, snap["model"][k])]
    diff += [f"ema {k}" for k, v in b.state.ema.state_dict().items()
             if not torch.equal(v, snap["ema"][k])]
    diff += [f"momentum {k}" for k, v in b._momentum().items() if not torch.equal(v, snap["mom"][k])]
    resumed = b.start_epoch == 1 and not diff and b.state.updates == a.state.updates
    x, t = (v.to(dev) for v in next(iter(b._device_batches(1))))
    step_ms = cuda_ms(lambda: b._step(1, 0, (x, t)), 3)
    emit(phase="office_trainer", model=name, card=card, dtype="bf16", batch=BATCH, img=IMG,
         images=OFFICE_TRAIN_IMAGES, steps=a.max_stepnum, updates=a.state.updates,
         running=running, epoch_s=epoch_s, train_launches=mid, eval_launches=ev_n,
         eval=metrics, meta_graph_is_office=ckpt["meta"]["graph"] == graph,
         resume_start_epoch=b.start_epoch, resume_entries_differing=len(diff),
         resume_first=diff[:3], step_ms=step_ms, step_img_per_s=BATCH / (step_ms / 1e3),
         note="step_ms: a train step of the resumed Trainer on a full batch (device aug "
              "included) by CUDA events; epoch_s: the first epoch by the host clock "
              "(its first steps build the cuDNN plans)")
    check(mid["dw_grad"] == 0 and mid["frontend"] == 0 and after["dw_grad"] == 0,
          f"office trainer: train launches {mid}, after the eval {after}")
    check(metrics is not None and all(np.isfinite(v) for v in metrics.values()),
          f"office trainer: eval {metrics}")
    check(ev_n["frontend"] == eval_batches and ev_n["greedy_nms"] >= eval_batches,
          f"office trainer: eval launches {ev_n} over {eval_batches} batches")
    check(ckpt["meta"]["graph"] == graph and ckpt["epoch"] == 0,
          "office trainer: the checkpoint's meta.graph is not the office graph")
    check(resumed, f"office trainer resume: start {b.start_epoch}, differs {diff[:3]}")
    ema_vars = state_dict_to_train_variables(a.state.ema.state_dict())
    del a, b, snap, x, t
    served = serve_ema(dev, graph, ema_vars, images(820, BATCH, IMG, IMG).to(dev),
                       phase="office_train_to_serve", label=name)
    total["frontend"] += served["frontend"]
    total["greedy_nms"] += served["greedy_nms"]
    tmp.cleanup()
    # In f32 this step sits on a ReLU gate: one pre-activation at layer 20's
    # first RepVGG block lies within f32 rounding of 0 (4.9e-7 of its
    # tensor's largest value), the card's f32 rounds it to the other side
    # of 0 than f64 does (with cuDNN, deterministic cuDNN, and without
    # cuDNN alike), and that one gate moves layer 20's gradients by 0.13 of
    # their scale; the CPU's f32 keeps the gate and sits 6e-3 to 9e-3 from
    # f64; each module alone is within 1.1e-5 of f64 on the card
    # (tools/grad_check.py; NVIDIA H100 80GB HBM3, 700.00 W). The card's f64
    # step is 1.6e-5 from the CPU's. So f64 is held and f32 recorded.
    step_card_vs_cpu(dev, graph, 0, phase="office_train_check", label=name,
                     dtype=torch.float64)
    step_card_vs_cpu(dev, graph, 0, phase="office_train_check_f32", label=name, gate=False)

    # one M step at bs8@640 in bf16: peak memory and time
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    m_graph = office_config_graph("yolov6m-office")
    model = build_model(m_graph, nc=NC).to(dev).to(memory_format=torch.channels_last)
    state = init_train_state(model, weight_decay=5e-4)
    step = make_train_step(num_classes=NC, img_size=IMG, dtype=torch.bfloat16)
    im, tg = train_batch(830, OFFICE_M_TRAIN_BATCH, IMG, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DG.dw_grad.launches = 0
    loss = {k: float(v) for k, v in step(state, im, tg, 0.01, 0.01, 0.01, 0.9, True,
                                         True).items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    m_ms = cuda_ms(lambda: step(state, im, tg, 0.01, 0.01, 0.01, 0.9, True, True), 3)
    emit(phase="office_m_train", model="yolov6m-office", card=card, dtype="bf16",
         batch=OFFICE_M_TRAIN_BATCH, img=IMG, loss=loss, peak_mem_gb=peak, step_ms=m_ms,
         img_per_s=OFFICE_M_TRAIN_BATCH / (m_ms / 1e3), dw_grad_launches=DG.dw_grad.launches,
         updates=state.updates)
    check(all(np.isfinite(v) for v in loss.values()) and state.updates >= 1,
          f"office M train step: {loss}")
    check(DG.dw_grad.launches == 0, "office M train step launched dw_grad")
    del model, state, step
    torch.cuda.empty_cache()


# export_quant: S, M and the office graphs served in real int8 at bs32@640
# (random_deploy weights, the office ones at OFFICE_GAIN), each calibrated
# from a seed on the card over EXPORT_CALIB_BATCHES batches and served on
# EXPORT_BATCHES more.
EXPORT_GRAPHS = ("maf-yolo-s", "maf-yolo-m", "yolov6n-office", "yolov6m-office",
                 "yolov6l-office")
EXPORT_CALIB_BATCHES = 2
EXPORT_BATCHES = 2
# The least share of the int8-sim predict's detections (score > 0.1) that
# the int8 predict of the same bs32 batch matches (match()), per graph: 0.6
# x the first card run's reading, 119 / 814, 104 / 760, 151 / 1171, 233 /
# 1309 and 357 / 704 (PERF.md §6, the office and S/M int8 entry; NVIDIA H100 80GB HBM3,
# 700.00 W), the rule of INT8_SHARE_FLOOR.
EXPORT_SHARE_FLOOR = {"maf-yolo-s": 0.087, "maf-yolo-m": 0.082, "yolov6n-office": 0.077,
                      "yolov6m-office": 0.106, "yolov6l-office": 0.304}
# The sites whose kernel times the phase reads: the office graphs' new
# dense class (3x3 stride 1: RepVGG deploy convs, Head_Effide's cls and reg
# convs) and S's and M's depthwise sites.
EXPORT_TIMED = {"maf-yolo-s": "dw", "maf-yolo-m": "dw", "yolov6n-office": "3x3s1",
                "yolov6m-office": "3x3s1", "yolov6l-office": "3x3s1"}
# The 3x3 stride-1 class's cold ms a predict on the windowed kernel of
# int8_conv.cu, before the class had its own kernel (PERF.md §6, the two
# card calls of its first run; NVIDIA H100 80GB HBM3, 700.00 W): the class
# line's prev_ms. That path is not built again to be timed.
EXPORT_PREV_MS = {"yolov6n-office": [3.629, 3.663], "yolov6m-office": [14.00, 13.87],
                  "yolov6l-office": [24.02, 23.82]}


def export_quant_phase(dev, card, folded_n):
    """Phase 27: S, M and the office graphs N, M and L in real int8, N
    exported with torch.export, and the FLOPs line.

    export_quant_3x3, first: the 3x3 stride-1 kernel's quantizer on every
    finite bf16 value and on f32 values at its rounding's edges, at five
    scales, through 16 channels that take its 16-byte loads
    (utils/sample.py:int8_quant_every_bf16), and its fused SiLU on
    every finite bf16 value, each bit-equal to the plain version's.

    Per graph of EXPORT_GRAPHS, on random_deploy weights:
    export_quant_calib: PTQ max calibration on the card over
    EXPORT_CALIB_BATCHES bs32@640 batches (every amax > 0); 2 images
    calibrated on the card and on the CPU (plain versions) agree at rtol
    1e-5, as N's. export_quant_sites: the int8 kernels against their plain
    versions (then torch's activation) on the real bf16 input of every
    distinct int8 conv site at bs2@640, with the activation its launch fuses
    and without it, bit for bit, a second launch bit-identical; each dense
    site's tile (ops/quant_conv.py:conv_tile) is reported. export_quant_int8:
    int8_predict_fn (bf16) over EXPORT_BATCHES bs32@640 batches with the
    launch counts read around that run: one int8_conv launch a dense site
    and one int8_dw launch a depthwise site a predict, of them one launch of
    the 3x3 stride-1 kernel (csrc/int8_conv3x3.cuh) a 3x3 stride-1 site
    (every office one; none in S and M), 1 NMS launch a batch
    (9 on overflow), no front-end launch; each 3x3 stride-1 site of the
    bs2@640 check also took that kernel, twice (check_int8_cases); the int8 predict against the
    int8-sim one (quantized_predict_fn, f32) on a batch: the share of the
    int8-sim detections (score > 0.1) matched, at least
    EXPORT_SHARE_FLOOR; img/s of the int8 predict beside the same graph's
    bf16 Evaler.predict, both as graphs_check timed their graphs; the
    kernel's ms per site of the class EXPORT_TIMED names, summed by class
    (tools/tune_kernels.py:time_int8_site: warm and cold, plain, bound,
    _int_mm, cuDNN bf16), with the office class's time before its kernel
    (EXPORT_PREV_MS) beside it as prev_ms.

    export: N (the slice's weights, calibrated here over
    EXPORT_CALIB_BATCHES batches) exported by tools/export.py at bs32@640 on
    the card with --end2end, for --quant none and int8: saved, loaded, run
    on a batch; the program's outputs equal the eager function's bit for
    bit; its graph holds mafyolo::greedy_nms (and mafyolo::int8_conv and
    int8_dw for int8), and the launches counted around the loaded program's
    run are 8 NMS (8 blocks of 256 of the 2000 candidates) and, for int8, 66
    int8_conv and 16 int8_dw.

    flops: tools/flops.py's line for N, S and M at 640 on the card, deploy
    form; N's params 3.76M.

    -> {"launches": the phase's launches by kernel (int8_conv: of the op,
    int8_conv3x3: of them the 3x3 stride-1 kernel's), "records": by graph,
    "kernel3x3": the kernels line's entry of the 3x3 stride-1 kernel (office
    L's class, the largest)}."""
    import pickle
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mafyolo_tpu_torch.core import quant as Q
    from mafyolo_tpu_torch.models.office import office_config_graph
    from mafyolo_tpu_torch.ops import _build
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops import quant_conv as QC
    from mafyolo_tpu_torch.tools import export as EX
    from mafyolo_tpu_torch.tools import flops as FL
    from mafyolo_tpu_torch.tools.tune_kernels import (int8_inputs, int8_site_class,
                                                      sum_int8_sites, time_int8_site)
    from mafyolo_tpu_torch.utils.sample import (images, int8_quant_every_bf16,
                                                int8_silu_every_bf16, random_deploy)
    from mafyolo_tpu_torch.utils.timing import cuda_ms
    bf16 = torch.bfloat16

    def counts():
        return {"int8_conv": QC.int8_conv.launches, "int8_dw": QC.int8_dw.launches,
                "greedy_nms": G.greedy_nms.launches, "frontend": FE.frontend_forward.launches,
                "int8_conv3x3": QC.int8_conv.launches_3x3}

    def zero():
        QC.int8_conv.launches = QC.int8_dw.launches = QC.int8_conv.launches_3x3 = 0
        G.greedy_nms.launches = FE.frontend_forward.launches = 0

    total = {"int8_conv": 0, "int8_dw": 0, "greedy_nms": 0, "int8_conv3x3": 0}
    records, shares, err3 = {}, {}, 0.0

    # ---- export_quant_3x3: the 3x3 stride-1 kernel's quantizer and fused
    # SiLU on every finite bf16 value (and the quantizer's rounding edges
    # in f32) against the plain version and torch
    n_q, q_differ = int8_quant_every_bf16(dev)
    n_s, s_differ = int8_silu_every_bf16(dev, 3)
    emit(phase="export_quant_3x3", quantizer_values=n_q, quantizer_differ=q_differ,
         silu_bf16_values=n_s, silu_differ=s_differ)
    check(q_differ == 0 and s_differ == 0,
          f"3x3 stride-1 kernel: quantizer differs on {q_differ}, SiLU on {s_differ} values")
    for name in EXPORT_GRAPHS:
        office = name.endswith("office")
        graph = office_config_graph(name) if office else name
        folded, over = random_deploy(graph, dev, OFFICE_GAIN[name] if office else 1.5)

        # ---- export_quant_calib
        calib = [images(900 + i, BATCH).to(dev) for i in range(EXPORT_CALIB_BATCHES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quant = Q.ptq_calibrate(graph, NC, folded, calib, max_batches=EXPORT_CALIB_BATCHES,
                                device=dev)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        amax = [float(v) for _, v in _tree_items(quant)]
        two = images(7, 2)
        rel = _tree_max_rel(
            Q.ptq_calibrate(graph, NC, folded, [two.to(dev)], max_batches=1, device=dev),
            Q.ptq_calibrate(graph, NC, folded, [two], max_batches=1, device="cpu"))
        emit(phase="export_quant_calib", model=name, batches=EXPORT_CALIB_BATCHES, batch=BATCH,
             img=IMG, leaves=len(amax), seconds=calib_s, amax_min=min(amax),
             amax_max=max(amax), card_vs_cpu_max_rel=rel)
        check(min(amax) > 0, f"{name} calibration: an amax of 0")
        check(rel <= 1e-5, f"{name} calibration card vs CPU: max rel {rel}")

        # ---- export_quant_sites: every distinct site at bs2@640
        p8 = Q.int8_predict_fn(graph, NC, folded, quant, device=dev)
        seen = int8_inputs(p8.model, Q.normalize(images(9, 2), bf16, dev))
        kinds = [p.kind for p, _, _ in seen.values()]
        n_dense, n_dw = kinds.count("dense"), kinds.count("dw")
        n_3x3 = sum(int8_site_class(p) == "3x3s1" for p, _, _ in seen.values())
        n_distinct, cases = distinct_int8_cases(seen)
        err, _ = check_int8_cases(cases, f"{name}: ")
        err3 = max(err3, err["3x3s1"])
        tiles, by_class = {}, {}
        for p, x in {tag: (p, x) for tag, p, x, _ in cases}.values():
            cls = int8_site_class(p)
            by_class[cls] = by_class.get(cls, 0) + 1
            if p.kind == "dense":
                ho, wo = QC._out_hw(x.shape[2], x.shape[3], p.k, p.stride, p.pad)
                tiles[f"{cls} {p.cin}->{p.cout} {ho}x{wo}"] = list(
                    QC.plan3x3(ho, wo, p.cin, p.cout, x.element_size(), BATCH,
                               _build.sm_count(dev.index)))[:7] if cls == "3x3s1" else \
                    list(QC.conv_tile(p.k, p.stride, p.pad, ho, wo, QC.pad16(p.cin),
                                      x.element_size()))
        emit(phase="export_quant_sites", model=name, sites=len(seen), dense=n_dense, dw=n_dw,
             sites_3x3s1=n_3x3, distinct=n_distinct, distinct_by_class=by_class,
             max_abs_err=err, tiles=tiles,
             tiles_note="3x3s1: plan3x3 at bs32 (th, tw, bnw, split_n, n_split, stages, kc); "
                        "other dense classes: conv_tile (th, tw)")

        # ---- export_quant_int8: the int8 predict, launch counts read around it
        batches = [images(910 + i, BATCH).to(dev) for i in range(EXPORT_BATCHES)]
        torch.cuda.synchronize()
        zero()
        outs, nms_per = [], []
        for bt in batches:
            before = G.greedy_nms.launches
            outs.append(p8(bt))
            nms_per.append(G.greedy_nms.launches - before)
        torch.cuda.synchronize()
        n = counts()
        for k in total:
            total[k] += n[k]
        check(n["int8_conv"] == n_dense * len(batches) and n["int8_dw"] == n_dw * len(batches)
              and n["int8_conv3x3"] == n_3x3 * len(batches),
              f"{name}: int8 launches {n} over {len(batches)} predicts ({n_dense} dense, "
              f"{n_3x3} of them 3x3 stride 1, {n_dw} dw sites)")
        check(n_3x3 > 0 if office else n_3x3 == 0, f"{name}: {n_3x3} 3x3 stride-1 sites")
        check(n["frontend"] == 0, f"{name}: the int8 predict launched the front-end kernel")
        check(all(k in (1, 9) for k in nms_per), f"{name}: NMS launches a batch {nms_per}")
        graphs_check(f"{name} int8", card, p8.graphs, p8, p8.eager, batches, over)
        check_dets(outs, BATCH, f"{name} int8 predict")
        psim = Q.quantized_predict_fn(graph, NC, folded, quant, device=dev)
        n_sim, m_sim = match(on_cpu(psim(batches[0])), on_cpu(outs[0]), 0.1)
        shares[name] = m_sim / max(n_sim, 1)
        del psim
        rate = {"int8_real": GRAPH_RATES[f"{name} int8"]["graph"],
                "bf16": GRAPH_RATES[f"{name} bf16"]["graph"]}
        x8 = Q.normalize(batches[0], bf16, dev)
        recs = [{"site": mname, "kind": p.kind, "class": int8_site_class(p),
                 **time_int8_site(p, xi, act)}
                for mname, (p, xi, act) in int8_inputs(p8.model, x8).items()
                if EXPORT_TIMED[name] in (p.kind, int8_site_class(p))]
        classes, _ = sum_int8_sites(recs)
        if office:
            classes["3x3s1"]["prev_ms"] = EXPORT_PREV_MS[name]
        records[name] = {"sites": len(seen), "dense": n_dense, "dw": n_dw, "rate": rate,
                         "classes": classes, "share": shares[name], "launches": n}
        emit(phase="export_quant_int8", model=name, card=card, batches=len(batches),
             launches=n, nms_launches_per_batch=nms_per, int8_conv_per_predict=n_dense,
             int8_conv3x3_per_predict=n_3x3,
             int8_dw_per_predict=n_dw, sim_dets_above_0p1=n_sim, int8_matched=m_sim,
             int8_share=shares[name], share_floor=EXPORT_SHARE_FLOOR[name], predict=rate,
             timed_class=EXPORT_TIMED[name], classes=classes,
             equal_to_plain=all(r["equal_to_plain"] for r in recs))
        check(all(r["equal_to_plain"] for r in recs), f"{name}: a timed site differs from plain")
        check(n_sim > 0 and shares[name] >= EXPORT_SHARE_FLOOR[name],
              f"{name} int8 vs int8-sim: {m_sim}/{n_sim} < {EXPORT_SHARE_FLOOR[name]}")
        del p8, seen, cases, outs, batches, calib, x8, recs
        torch.cuda.empty_cache()

    # ---- export: N at bs32@640 on the card, --end2end, none and int8
    calib = [images(900 + i, BATCH).to(dev) for i in range(EXPORT_CALIB_BATCHES)]
    quant_n = Q.ptq_calibrate("maf-yolo-n", NC, folded_n, calib,
                              max_batches=EXPORT_CALIB_BATCHES, device=dev)
    bt = images(920, BATCH).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "n_calib.npck")
        with open(weights, "wb") as f:
            pickle.dump({"model": folded_n, "quant": quant_n, "folded": True, "ema": None,
                         "meta": {"graph": "maf-yolo-n", "nc": NC}}, f, protocol=4)
        for quant in ("none", "int8"):
            argv = ["--weights", weights, "--img-size", str(IMG), "--batch-size", str(BATCH),
                    "--end2end", "--conf-thres", "0.03", "--iou-thres", "0.65",
                    "--quant", quant, "--out", os.path.join(tmp, quant), "--device", str(dev)]
            t0 = time.perf_counter()
            path = EX.run(EX.get_args_parser().parse_args(argv))
            export_s = time.perf_counter() - t0
            program = torch.export.load(path)
            targets = [str(nd.target) for nd in program.graph.nodes if nd.op == "call_function"]
            ops = {op: targets.count(f"mafyolo.{op}.default")
                   for op in ("greedy_nms", "int8_conv", "int8_dw")}
            run = program.module()
            eager = EX.deploy_function("maf-yolo-n", NC, folded_n, quant_n, quant, True, 0.03,
                                       0.65, 300, dev)
            want = eager(bt)
            run(bt)                                  # warm up
            torch.cuda.synchronize()
            zero()
            got = run(bt)
            torch.cuda.synchronize()
            n = counts()
            for k in total:
                total[k] += n[k]
            same = {k: bool(torch.equal(got[k], want[k])) for k in want}
            mean_ms = {"program": cuda_ms(lambda: run(bt), 3),
                       "eager": cuda_ms(lambda: eager(bt), 3)}
            # the device's work a batch, program against eager: busy ms,
            # device ops and the five largest by summed ms
            prof_rec = {}
            for tag, fn in (("program", run), ("eager", eager)):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn(bt)
                    torch.cuda.synchronize()
                busy_us, spans, by_name = device_busy(prof)
                prof_rec[tag] = {"busy_ms": busy_us / 1e3, "device_ops": len(spans),
                                 "top": sorted(((v / 1e3, k[:60]) for k, v in by_name.items()),
                                               reverse=True)[:5]}
            emit(phase="export", model="maf-yolo-n", quant=quant, card=card, batch=BATCH,
                 img=IMG, export_seconds=export_s, pt2_bytes=os.path.getsize(path),
                 graph_ops=ops, launches=n, equal_to_eager=same,
                 dets_per_image_mean=float(got["valid"].sum(1).float().mean().item()),
                 batch_ms=mean_ms, device=prof_rec)
            want_ops = {"greedy_nms": 8, "int8_conv": 66 if quant == "int8" else 0,
                        "int8_dw": 16 if quant == "int8" else 0}
            check(n["int8_conv3x3"] == 0, f"export {quant}: N launched the 3x3 kernel")
            check(ops == want_ops, f"export {quant}: graph ops {ops}")
            check({k: n[k] for k in want_ops} == want_ops and n["frontend"] == 0,
                  f"export {quant}: launches of the loaded program's run {n}")
            check(all(same.values()), f"export {quant}: the program differs from eager {same}")
            del program, run, eager, got, want

    # ---- flops: the CLI's line for N, S and M at IMG, deploy form
    lines = [FL.main(["--graph", g, "--img-size", str(IMG), "--device", str(dev)])
             for g in ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m")]
    emit(phase="flops", lines=lines)
    check(lines[0].startswith(f"maf-yolo-n @{IMG}: params 3.76M"), f"flops: {lines[0]}")
    emit(phase="export_quant_shares", shares=shares, floors=EXPORT_SHARE_FLOOR, launches=total)
    cls = records["yolov6l-office"]["classes"]["3x3s1"]
    kernel3x3 = {
        "name": "int8_conv3x3", "route": "cuda",
        "source": "mafyolo_tpu_torch/csrc/int8_conv3x3.cuh",
        "replaces": "none (a class of mafyolo_tpu/models/blocks.py:306-321, an XLA conv; "
                    "redesigned from csrc/int8_conv.cu's windowed kernel)",
        "launches": total["int8_conv3x3"], "max_abs_err": err3, "ms": cls["cold_ms"],
        "warm_ms": cls["ms"], "plain_ms": cls["plain_ms"], "bound_ms": cls["bound_ms"],
        "bound_by": cls["bound_by"], "library_ms": cls["int_mm_ms"],
        "library_covers": "office L's 96 3x3 stride-1 sites a bs32@640 predict, summed: "
                          "torch._int_mm on the quantized operands unfolded to [M, 9C] (no "
                          "quantization or epilogue; the unfold not timed); cuDNN's bf16 "
                          "conv of the sites in export_quant_int8's classes"}
    return {"launches": total, "records": records, "kernel3x3": kernel3x3}


# remat: per-block rematerialization at bs32@640 bf16. Each graph's steps
# REMAT_PLAN, (epoch, step, use_atss) on the Trainer's schedule at bs 32
# (accumulate 2: an odd step applies), run from one state under each mode,
# then REMAT_TIMED steady steps a mode.
REMAT_GRAPHS = ("maf-yolo-n", "maf-yolo-m", "yolov6l-office")
REMAT_PLAN = ((2, 0, True), (2, 1, True), (3, 0, False), (3, 1, False))
REMAT_TIMED = 4
REMAT_IMAGES = 40           # office L's Trainer epoch: batches of 32 and 8


def remat_phase(dev, card):
    """Phase 28: per-block rematerialization (models/graph.py:GraphNet remat,
    policies "full" and "convs") at full width. For MAF-YOLO-N, -M and the
    YOLOv6-L office graph at bs32@640 in bf16 through make_train_step on
    REMAT_PLAN, from one state (the seeded init): two runs without remat
    (their largest leaf error is the card's run-to-run spread), one under
    "full" and one under "convs", each held to the first by
    utils/sample.py:state_gate over params, BN running statistics,
    momentum, EMA and wiou_mean (bit-equal where the two runs without remat
    are, else within twice their spread). Then per mode REMAT_TIMED steady
    steps by CUDA events (p50, p90), the peak memory of the mode's runs
    (reset before each mode), the dw_grad launches a step (one a DW site in
    every mode: the recompute builds no backward of its own) and the
    device's busy share over one profiled apply step. A mode that does not
    fit in the card's memory says so with the OOM's request. Office L also:
    an f64 step at bs2@160 under remat, card against CPU; one Trainer epoch
    with --remat --device-aug on REMAT_IMAGES images held in memory,
    evaluated (L runs its own layers 0-1: no front-end launch; the NMS
    kernel) and checkpointed. Last, the train CLI with --remat for an epoch
    of 2 steps of N at bs8@320: its checkpointed block calls counted (every
    block row, every step) and its dw_grad launches. -> the phase's
    launches by kernel."""
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mafyolo_tpu_torch.core.engine import Schedule, Trainer
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models import graph as GR
    from mafyolo_tpu_torch.models.office import office_config_graph
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.tools import train as train_cli
    from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import (ArrayDataset, dw_sites, eval_set, state_gate,
                                                train_set, train_state_leaves)
    cl = torch.channels_last

    DG.dw_grad.launches = FE.frontend_forward.launches = G.greedy_nms.launches = 0
    DD.dw_conv.launches = 0
    cfg = Config.fromfile(os.path.join(HERE, "configs", "maf_yolo_n.py"))
    sched = Schedule(cfg.solver, BATCH, 300, STEPS_PER_EPOCH)
    check(sched.lrs(0, 2)["accumulate"] == 2, "remat: the bs32 schedule does not accumulate 2")
    plan = [(sched.lrs(i, ep), i % 2 == 1, atss) for ep, i, atss in REMAT_PLAN]

    for name in REMAT_GRAPHS:
        graph = office_config_graph(name) if name.endswith("-office") else name
        torch.manual_seed(0)
        model = build_model(graph, nc=NC).to(dev).to(memory_format=cl)
        n_sites = len(dw_sites(model, IMG, dev))
        sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        step = make_train_step(num_classes=NC, img_size=IMG, dtype=torch.bfloat16)
        batches = [train_batch(900 + i, BATCH, IMG, dev) for i in range(len(plan))]

        def run(state, idx, events=None):
            for i in idx:
                lrs, do_apply, use_atss = plan[i % len(plan)]
                im, tg = batches[i % len(batches)]
                if events is not None:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                step(state, im, tg, lrs["lr_bnw"], lrs["lr_weight"], lrs["lr_bias"],
                     lrs["momentum"], do_apply, use_atss)
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()

        leaves, lines = {}, {}
        for run_name, mode in (("off", "off"), ("off_again", "off"), ("full", "full"),
                               ("convs", "convs")):
            timed = run_name != "off_again"
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            if timed:
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated() / 2**30
            state = None
            try:
                model.load_state_dict(sd0)
                model.zero_grad(set_to_none=True)
                model.net.set_remat(mode != "off", "full" if mode == "off" else mode)
                state = init_train_state(model, weight_decay=sched.weight_decay,
                                         lr0=sched.lr0, momentum=cfg.solver["momentum"])
                run(state, range(len(plan)))
                torch.cuda.synchronize()
                leaves[run_name] = train_state_leaves(state)
                if timed:
                    events, before = [], DG.dw_grad.launches
                    run(state, range(REMAT_TIMED), events)
                    torch.cuda.synchronize()
                    per_step = (DG.dw_grad.launches - before) / REMAT_TIMED
                    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        ev = []
                        run(state, [1], ev)
                        torch.cuda.synchronize()
                    busy_us = device_busy(prof)[0]
                    prof_ms = ev[0].elapsed_time(ev[1])
                    lines[mode] = dict(
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, held_gb=held,
                        step_ms_p50=float(np.percentile(ms, 50)),
                        step_ms_p90=float(np.percentile(ms, 90)), step_ms=ms,
                        dw_grad_launches_per_step=per_step, profiled_step_ms=prof_ms,
                        device_busy_ms=busy_us / 1e3, busy_share=busy_us / 1e3 / prof_ms)
            except torch.cuda.OutOfMemoryError as e:
                lines[mode] = {"oom": str(e).split("\n")[0][:300],
                               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
            del state
        torch.cuda.empty_cache()
        gates = {}
        for mode in ("full", "convs"):
            if {"off", "off_again", mode} <= leaves.keys():
                gates[mode] = state_gate(leaves["off"], leaves["off_again"], leaves[mode])
        for mode in ("off", "full", "convs"):
            emit(phase="remat", model=name, mode=mode, card=card, dtype="bf16", batch=BATCH,
                 img=IMG, dw_sites=n_sites,
                 remat_rows=sum(s.kind in GR._BLOCK_CTORS for s in model.net.specs),
                 plan=[{"epoch": ep, "step": i, "atss": a} for ep, i, a in REMAT_PLAN],
                 timed_steps=REMAT_TIMED, **lines.get(mode, {}), gate=gates.get(mode),
                 note="step ms by CUDA events over steady steps (accumulate-only and apply "
                      "alternate); peak memory over the mode's runs, held_gb allocated at "
                      "their start (the model and what earlier phases keep); busy share: "
                      "the union of the device's spans over one profiled apply step")
        emit(phase="remat_gate", model=name, card=card, steps=len(plan),
             spread=(gates.get("full") or gates.get("convs") or {}).get("spread"),
             err={m: g["err"] for m, g in gates.items()},
             leaves_equal_off={m: g["leaves_equal_off"] for m, g in gates.items()},
             note="spread: the largest leaf error between two runs without remat from one "
                  "state; err: each mode's against the first (utils/sample.py:state_gate)")
        # without remat office L may not fit; with it every graph must
        for mode in ("off", "full", "convs"):
            check("oom" not in lines[mode] or (mode, name) == ("off", "yolov6l-office"),
                  f"remat {name}: {mode} did not fit: {lines[mode]}")
        for mode, line in lines.items():
            if "oom" not in line:
                check(line["dw_grad_launches_per_step"] == n_sites,
                      f"remat {name} {mode}: dw_grad {line['dw_grad_launches_per_step']} a "
                      f"step, {n_sites} DW sites")
                check(line["device_busy_ms"] > 0, f"remat {name} {mode}: no device activity")
        for mode, g in gates.items():
            check(g["ok"], f"remat {name} {mode}: state gate {g}")
        check(gates or "oom" in lines["off"], f"remat {name}: no gate ran")
        del model, sd0, step, batches, leaves
        torch.cuda.empty_cache()

    # office L: the f64 step card against CPU under remat, then a Trainer epoch
    name = "yolov6l-office"
    graph = office_config_graph(name)
    step_card_vs_cpu(dev, graph, 0, phase="remat_office_l_check", label=name,
                     dtype=torch.float64, remat=True)
    tmp = tempfile.TemporaryDirectory()
    data = {"train": train_set(60, REMAT_IMAGES, size=IMG),
            "val": eval_set(61, [(IMG, IMG)] * 8 + [(IMG * 3 // 4, IMG)] * 8), "nc": NC,
            "names": [str(c) for c in range(NC)]}
    eval_batches = -(-len(data["val"]["images"]) // min(2 * BATCH, 64))
    args = SimpleNamespace(img_size=IMG, batch_size=BATCH, epochs=1, workers=8, seed=0,
                           save_dir=os.path.join(tmp.name, "l"), device_aug=True,
                           stop_aug_last_n_epoch=0, eval_interval=1, tensorboard=False,
                           remat=True)
    tr = Trainer(args, office_config(name), data, device=dev, dataset_cls=ArrayDataset)
    net = tr.state.model.net
    wrapped = net.remat and net.remat_policy == "full" and len(net.remat_rows) > 0
    before = {"dw_grad": DG.dw_grad.launches, "frontend": FE.frontend_forward.launches,
              "greedy_nms": G.greedy_nms.launches}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    running = tr.train_one_epoch(0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    mid = {"dw_grad": DG.dw_grad.launches, "frontend": FE.frontend_forward.launches,
           "greedy_nms": G.greedy_nms.launches}
    metrics = tr.eval_and_save(0)
    torch.cuda.synchronize()
    ev_n = {"frontend": FE.frontend_forward.launches - mid["frontend"],
            "greedy_nms": G.greedy_nms.launches - mid["greedy_nms"]}
    ckpt = load_checkpoint(os.path.join(tmp.name, "l", "last_ckpt.npck"))
    emit(phase="remat_office_l_trainer", model=name, card=card, dtype="bf16", batch=BATCH,
         img=IMG, images=REMAT_IMAGES, steps=tr.max_stepnum, updates=tr.state.updates,
         remat_rows=len(net.remat_rows), policy=net.remat_policy, running=running,
         epoch_s=epoch_s, peak_mem_gb=peak,
         train_launches={k: mid[k] - before[k] for k in mid}, eval_launches=ev_n,
         eval=metrics, checkpoint_epoch=ckpt["epoch"],
         note="epoch_s by the host clock, its first steps building the cuDNN plans")
    check(wrapped, "remat office L trainer: the block rows are not rematerialized")
    check(all(np.isfinite(v) for v in running.values()), f"remat office L trainer: {running}")
    check(mid["dw_grad"] == before["dw_grad"] and mid["frontend"] == before["frontend"],
          f"remat office L trainer: train launches {mid} from {before}")
    check(metrics is not None and all(np.isfinite(v) for v in metrics.values()),
          f"remat office L trainer: eval {metrics}")
    check(ev_n["frontend"] == 0 and ev_n["greedy_nms"] >= eval_batches,
          f"remat office L trainer: eval launches {ev_n} over {eval_batches} batches")
    check(ckpt["epoch"] == 0, "remat office L trainer: no checkpoint of epoch 0")
    del tr, net, ckpt
    tmp.cleanup()
    torch.cuda.empty_cache()

    # the train CLI with --remat: two steps of N at bs8@320, one rank here
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "runs")
    args = train_cli.get_args_parser().parse_args(
        ["--conf", os.path.join(HERE, "configs", "maf_yolo_n.py"), "--img-size", str(DDP_IMG),
         "--batch-size", "8", "--epochs", "1", "--workers", "4", "--output-dir", out,
         "--device-aug", "--stop-aug-last-n-epoch", "0", "--device", dev.type, "--remat"])
    n_model = build_model("maf-yolo-n", nc=NC).to(dev).to(memory_format=cl)
    n_sites = len(dw_sites(n_model, DDP_IMG, dev))
    n_rows = len(build_model("maf-yolo-n", nc=NC, remat=True).net.remat_rows)
    del n_model
    calls, checkpoint = [0], GR.ckpt.checkpoint

    def counted(*a, **kw):
        calls[0] += 1
        return checkpoint(*a, **kw)
    before = DG.dw_grad.launches
    GR.ckpt.checkpoint = counted
    t_cli = time.perf_counter()
    try:
        train_cli.main(args, data_dict={"train": train_set(43, 16, size=DDP_IMG), "nc": NC},
                       dataset_cls=ArrayDataset)
    finally:
        GR.ckpt.checkpoint = checkpoint
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t_cli
    cli_launches = DG.dw_grad.launches - before
    ckpt = load_checkpoint(os.path.join(out, "exp", "last_ckpt.npck"))
    finite = all(np.isfinite(v).all() for _, v in _tree_items(ckpt["model"]))
    emit(phase="remat_cli", batch=8, img=DDP_IMG, steps=2, checkpointed_calls=calls[0],
         remat_rows=n_rows, dw_grad_launches=cli_launches, wall_s=cli_s,
         checkpoint_epoch=ckpt["epoch"], checkpoint_finite=finite,
         note="checkpointed_calls: torch.utils.checkpoint.checkpoint calls in the run")
    check(calls[0] == 2 * n_rows, f"remat_cli: {calls[0]} checkpointed calls, want 2 x {n_rows}")
    check(cli_launches == 2 * n_sites, f"remat_cli: dw_grad launches {cli_launches}")
    check(finite and ckpt["epoch"] == 0, "remat_cli: bad checkpoint")
    tmp.cleanup()
    return {"dw_grad": DG.dw_grad.launches, "frontend": FE.frontend_forward.launches,
            "greedy_nms": G.greedy_nms.launches, "dw_conv": DD.dw_conv.launches}


# overfit: MAF-YOLO-N trained to boxes (tools/overfit.py), then served: the
# first OVERFIT_STEPS steps of the tool's 960-step run (its lr schedule, so
# the curve is the tool's and, at step 480, JAX's epoch 59's), the most that
# keep the phase near 150 s on the card; an eval every 10 epochs of 8 steps.
OVERFIT_STEPS = 480
OVERFIT_AP50_FLOOR = 0.5    # the trained EMA's f32 AP50 on the val set
# The least share of the f32 predict's detections (score > 0.1, match()'s
# criterion) that the bf16 predict matches, and of the int8-sim predict's
# that the int8 predict matches (bf16 activations, and in f32: the quant
# effect alone), on a val batch of the trained checkpoint: 0.9 x the first
# card readings, 356 / 482, 60 / 497 and 154 / 497 (PERF.md §6, the overfit
# entry; NVIDIA H100 80GB HBM3, 700.00 W; random heads gave N 0.035-0.107
# and 0.094). Training on the card repeats bit for bit (the same curve in
# every run), so the readings repeat; the margin covers a cuDNN or CUDA
# version that moves a last bit. int8_vs_int8_f32, the dtype effect, is
# reported.
TRAINED_SHARE_FLOOR = {"bf16_vs_f32": 0.665, "int8_vs_sim": 0.108, "int8_f32_vs_sim": 0.279}
# AP on the val set: bf16 within this of f32, int8-real of int8-sim; int8-
# real at least the quantize CLI's fp AP less INT8_AP_LOSS
AP_DELTA, INT8_AP_LOSS = 0.02, 0.03


def overfit_phase(dev, card):
    """Phase 29: MAF-YOLO-N trained to boxes on the card and its best
    checkpoint served on every path (tools/overfit.py: the JAX package's
    synthetic overfit; its docstring has the recipe). overfit_eval: a line
    an eval (epoch, step, the loss parts' mean since the last eval, the
    weight lr, the bf16 EMA's AP and AP50 on the 64 val images, img/s).
    overfit_train gates: dw_grad launches 53 sites x the steps (each call
    launches its tile and reduce kernels: twice that in kernels); each eval
    one front-end launch a rect batch and no dw_grad; the mean loss of the
    last eval's window under the first's; best_ckpt written. overfit_serve
    gates, on the stripped best_ckpt (the EMA): f32 AP50 at least
    OVERFIT_AP50_FLOOR; bf16 AP within AP_DELTA of f32 (the CUDA graphs:
    front-end and NMS kernels); the quantize CLI's int8-real AP within
    AP_DELTA of int8-sim and at least its fp AP less INT8_AP_LOSS, its
    int8 launches 66 int8_conv and 16 int8_dw a square batch; each exported
    program's AP (--end2end, none and int8) equal to its eager function's,
    the int8 program's launches those of the eager function. overfit_shares:
    on the first 32 val images (square letterbox), bf16 against f32
    Evaler.predict, int8_predict_fn (bf16, and f32) against
    quantized_predict_fn, each share at least TRAINED_SHARE_FLOOR (of at
    least 100 reference detections); int8 bf16 against int8 f32 reported."""
    import tempfile

    import torch

    from mafyolo_tpu_torch.core import quant as Q
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.tools import overfit as OF
    from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
    from mafyolo_tpu_torch.utils.sample import ArrayDataset

    t_phase, start = time.perf_counter(), OF.launch_counts()
    data = OF.synth_data()
    nc, n_val = data["nc"], len(data["val"]["images"])
    val_batches = -(-n_val // BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        res = OF.train(OVERFIT_STEPS, tmp, data, dev, schedule_steps=OF.STEPS,
                       on_eval=lambda rec: emit(phase="overfit_eval", card=card, **rec))
        curve, steps, ev_l = res["curve"], res["steps"], res["launches"]["evals"]
        st_l = res["launches"]["steps"]
        emit(phase="overfit_train", card=card, **{k: v for k, v in res.items() if k != "curve"},
             dw_grad_kernel_launches=2 * st_l["dw_grad"], evals=len(curve),
             jax_tpu_record={"epoch59_AP": 0.49, "epoch89_AP": 0.68, "epoch119_AP": 0.724,
                             "epoch119_AP50": 0.947, "source": "docs/STATUS.md"})
        check(steps == OVERFIT_STEPS and st_l["dw_grad"] == res["dw_sites"] * steps,
              f"overfit: dw_grad launches {st_l['dw_grad']} over {steps} steps, "
              f"{res['dw_sites']} sites")
        check(st_l["frontend"] == 0 and ev_l["dw_grad"] == 0
              and ev_l["frontend"] == len(curve) * -(-n_val // min(2 * BATCH, 64))
              and ev_l["greedy_nms"] >= ev_l["frontend"], f"overfit launches {res['launches']}")
        check(len(curve) >= 2 and curve[-1]["step"] == steps
              and curve[-1]["loss"]["loss"] < curve[0]["loss"]["loss"],
              f"overfit: the loss did not fall: {[c['loss']['loss'] for c in curve]}")
        check(os.path.exists(res["best_ckpt"]), f"overfit: no best_ckpt (best AP {res['best_ap']})")

        served = OF.serve(res["best_ckpt"], data, tmp, dev)
        ap = {"f32": served["f32"], "bf16": served["bf16"], **served["quant"],
              **{f"export_{q}_{r}": m for q, e in served["export"].items() for r, m in e.items()}}
        emit(phase="overfit_serve", card=card, ap={k: v["AP"] for k, v in ap.items()},
             ap50={k: v["AP50"] for k, v in ap.items()}, launches=served["launches"],
             seconds=served["seconds"],
             note="f32, bf16: run_eval on rect batches of 32; fp, int8-sim, int8-real: "
                  "tools/quantize.run --eval (square batches of 32, fp in bf16); export: "
                  "each .pt2 program and its eager function through the Evaler's loop "
                  "(square batches of 32)")
        la = served["launches"]
        check(served["f32"]["AP50"] >= OVERFIT_AP50_FLOOR,
              f"overfit: f32 AP50 {served['f32']['AP50']} < {OVERFIT_AP50_FLOOR}")
        check(abs(served["bf16"]["AP"] - served["f32"]["AP"]) <= AP_DELTA,
              f"overfit: bf16 AP {served['bf16']['AP']} against f32 {served['f32']['AP']}")
        check(all(la[t]["frontend"] == val_batches and la[t]["greedy_nms"] >= val_batches
                  for t in ("f32", "bf16")), f"overfit: eval launches {la}")
        q = served["quant"]
        check(abs(q["int8-real"]["AP"] - q["int8-sim"]["AP"]) <= AP_DELTA
              and q["int8-real"]["AP"] >= q["fp"]["AP"] - INT8_AP_LOSS,
              f"overfit: int8 AP {q['int8-real']['AP']}, sim {q['int8-sim']['AP']}, "
              f"fp {q['fp']['AP']}")
        check(la["quant"]["int8_conv"] == 66 * val_batches
              and la["quant"]["int8_dw"] == 16 * val_batches,
              f"overfit: int8 launches over the quantize CLI's evals {la['quant']}")
        for qt, e in served["export"].items():
            check(e["program"] == e["eager"], f"overfit: export {qt} AP {e}")
            lp, le = la[f"export_{qt}_program"], la[f"export_{qt}_eager"]
            check(lp == le and lp["int8_conv"] == (66 * val_batches if qt == "int8" else 0)
                  and lp["greedy_nms"] > 0, f"overfit: export {qt} launches {lp} / {le}")

        # the shares on trained heads: a square val batch of 32
        ckpt, calib = load_checkpoint(res["best_ckpt"]), load_checkpoint(served["calib_ckpt"])
        graph = ckpt["meta"]["graph"]
        ev = Evaler(data, img_size=IMG, batch_size=BATCH, dataset_cls=ArrayDataset, device=dev)
        imgs = torch.from_numpy(next(iter(ev.init_data()))[0]).to(dev)
        preds = {}
        for tag, half in (("f32", False), ("bf16", True)):
            e = Evaler(half=half, device=dev)
            e.init_model(graph, eval_variables(ckpt), nc)
            preds[tag] = on_cpu(e.predict(imgs))
        folded, quant = {"params": calib["model"]["params"]}, calib["quant"]
        for tag, dtype in (("int8", torch.bfloat16), ("int8_f32", torch.float32)):
            preds[tag] = on_cpu(Q.int8_predict_fn(graph, nc, folded, quant, dtype=dtype,
                                                  device=dev)(imgs))
        preds["sim"] = on_cpu(Q.quantized_predict_fn(graph, nc, folded, quant, device=dev)(imgs))
        shares = {}
        for key, (ref, got) in {"bf16_vs_f32": ("f32", "bf16"), "int8_vs_sim": ("sim", "int8"),
                                "int8_f32_vs_sim": ("sim", "int8_f32"),
                                "int8_vs_int8_f32": ("int8_f32", "int8")}.items():
            n_ref, matched = match(preds[ref], preds[got], 0.1)
            shares[key] = {"ref_dets_above_0p1": n_ref, "matched": matched,
                           "share": matched / max(n_ref, 1)}
        check_dets(list(preds.values()), BATCH, "overfit predicts")
    seconds = time.perf_counter() - t_phase
    emit(phase="overfit_shares", card=card, shares=shares, floors=TRAINED_SHARE_FLOOR,
         random_head_floors={"bf16": BF16_SHARE_FLOOR, "int8": INT8_SHARE_FLOOR},
         phase_seconds=seconds)
    for key, floor in TRAINED_SHARE_FLOOR.items():
        check(shares[key]["ref_dets_above_0p1"] >= 100 and shares[key]["share"] >= floor,
              f"overfit: {key} share {shares[key]} < {floor}")
    return {k: v - start[k] for k, v in OF.launch_counts().items()}


if __name__ == "__main__":
    main()
