#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mafyolo_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without a result line:
  1. device     a CUDA card is present; print its name and power limit;
  2. build      nvcc-build the hand-written kernels from mafyolo_tpu_torch/csrc;
  3. frontend   the fused front-end kernel against its plain version
                (N bs4@640, S bs2@640, a 256x64 N batch; f32 and bf16);
  4. nms        the greedy-NMS kernel against its plain version (B=32,
                M=512 and M=2000), keep sets exactly equal;
  5. dw_grad    the depthwise weight-gradient kernel against its plain
                version at every (C, H, k) of N's train graph at B=2, plus a
                dilation-2 case and odd sizes; f32 and bf16;
  6. slice      MAF-YOLO-N deploy Evaler.predict in bf16, bs32 uint8 @640,
                for BATCHES batches plus one batch that overflows into the
                dense NMS path, with every kernel's launch count read around
                that run; then the card in f32 against the CPU plain path on
                2 images @640;
  7. timings    CUDA-event times: e2e img/s and p50 batch latency at bs32@640
                and each kernel beside its plain version at main-path shapes;
  8. train      MAF-YOLO-N train steps at bs32@640 in bf16 through the port's
                engine loop (accumulate 2: accumulate-only and apply steps
                alternate; ATSS epoch, then TAL epoch), with the dw_grad
                launch count read around that run;
  9. train_check  one f32 step of N at bs2@160 on the card against the CPU
                plain path: loss components, every gradient, BN stats;
 10. train_to_serve  the EMA folded into the deploy model, Evaler.predict;
                the folded model in f32 against the train form in eval mode
                on the same EMA weights (every head's inner outputs);
 11. timing_train  train-step img/s and its stage split; the device's busy
                time and idle share over two profiled steps; the dw_grad
                kernel against its plain version at every DW site at B=32
                (values and determinism), and the summed dk time per step,
                kernel against plain.
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
STEPS_PER_EPOCH = 3665     # COCO train2017 (117266 images) at bs 32
TRAIN_STEPS = 4            # per epoch: an ATSS epoch, then a TAL epoch


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def events_ms(fn, iters, warmup=2):
    """Mean milliseconds per call of fn on the card, by CUDA events."""
    import torch
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


def dw_sites(model, img, device):
    """[(C, H, W, k, pad, dilation)] of every depthwise conv of a train-form
    model at img x img, read from one forward (a dw_grad launch each per
    backward)."""
    import torch
    from mafyolo_tpu_torch.models.blocks import DWConv
    sites, hooks = [], []
    for m in model.modules():
        if isinstance(m, DWConv):
            k = m.weight.shape[-1]
            hooks.append(m.register_forward_hook(
                lambda mod, a, o, k=k: sites.append(
                    (a[0].shape[1], a[0].shape[2], a[0].shape[3], k, mod.pad,
                     mod.dilation))))
    with torch.no_grad():
        model.eval()(torch.zeros(1, img, img, 3, device=device))
    for h in hooks:
        h.remove()
    return sites


def train_batch(seed, b, img, device, max_boxes=120):
    """uint8 BGR images [b,img,img,3] and padded targets [b,max_boxes,5]
    (1-30 boxes per image: cls, cx, cy, w, h normalized; pad rows cls -1),
    made on the device from a seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.randint(0, 256, (b, img, img, 3), generator=gen, device=device,
                         dtype=torch.uint8)
    u = torch.rand((b, max_boxes, 5), generator=gen, device=device)
    n = torch.randint(1, 31, (b, 1), generator=gen, device=device)
    real = torch.arange(max_boxes, device=device)[None, :] < n
    wh = 0.03 + 0.5 * u[..., 3:5]
    xy = wh / 2 + u[..., 1:3] * (1 - wh)
    cls = (u[..., 0] * NC).floor().clamp(max=NC - 1)
    t = torch.cat([cls[..., None], xy, wh], -1)
    t = torch.where(real[..., None], t, torch.zeros_like(t))
    t[..., 0] = torch.where(real, t[..., 0], -1.0)
    return imgs, t


def dw_grad_phase(dev):
    """Phase 5: the dw_grad kernel against its plain version at every DW site
    of N's train graph at B=2, a dilation-2 k9 case at H=20 and an odd size;
    f32 and bf16. Returns the largest error."""
    import torch

    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.ops import dw_grad as DG
    cl = torch.channels_last
    torch.manual_seed(0)
    sites = dw_sites(build_model("maf-yolo-n", nc=NC).to(dev).to(memory_format=cl), IMG, dev)
    cases = sorted(set(sites)) + [(64, 20, 20, 9, 8, 2), (48, 37, 23, 5, 2, 1)]
    dk_err = 0.0
    for c, h, w, k, pad, dil in cases:
        gen = torch.Generator(device=dev).manual_seed(c * 1000 + h * 10 + k)
        # an offset keeps x nonzero at every border
        x32 = (torch.randn((2, c, h, w), generator=gen, device=dev) + 0.5) \
            .contiguous(memory_format=cl)
        g32 = torch.randn((2, c, h, w), generator=gen, device=dev).contiguous(memory_format=cl)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            x, g = x32.to(dt), g32.to(dt)
            want = DG.dw_grad_plain(x, g, k, pad, dil)
            got = DG.dw_grad(x, g, k, pad, dil)
            again = DG.dw_grad(x, g, k, pad, dil)
            err = (got - want).abs().max().item()
            bound = 1e-3 * want.abs().max().item()
            errs[str(dt).split(".")[1]] = (err, bound)
            check(err <= bound, f"dw_grad kernel vs plain {dt} C{c} H{h} W{w} k{k} d{dil}: "
                                f"{err} > {bound}")
            check(torch.equal(got, again), f"dw_grad not deterministic C{c} H{h} k{k}")
            dk_err = max(dk_err, err)
        emit(phase="dw_grad_check", c=c, h=h, w=w, k=k, dilation=dil, batch=2,
             max_abs_err_f32=errs["float32"][0], bound_f32=errs["float32"][1],
             max_abs_err_bf16=errs["bfloat16"][0], bound_bf16=errs["bfloat16"][1],
             tolerance="1e-3 * max|plain| for both; bf16 inputs are the same "
                       "numbers for both versions, each accumulates in f32")
    emit(phase="dw_grad_sites", sites=len(sites), distinct=len(set(sites)))
    return dk_err


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

    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.models.graph import parse_graph
    from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
    from mafyolo_tpu_torch.ops import _build
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.ops.boxes import box_iou_pairwise
    from mafyolo_tpu_torch.ops.nms import fused_decode_nms
    from mafyolo_tpu_torch.utils.bridge import random_folded_variables

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
    names = ("frontend", "greedy_nms", "dw_grad")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    for name in names:
        secs, log = _build.BUILD_LOG.get(name, (time.perf_counter() - t0, ""))
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit(phase="build", kernel=name, seconds=secs,
             lib=os.path.relpath(paths[name], HERE), ptxas=ptxas)

    def models(folded, half, device):
        ev = Evaler(half=half, device=device)
        ev.init_model("maf-yolo-n", folded, nc=NC, folded=True)
        return ev

    def images(seed, b, h=IMG, w=IMG):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, (b, h, w, 3), dtype=np.uint8))

    # ---- 3. front-end kernel vs plain
    fe_err = {}
    for name, b, (h, w) in (("maf-yolo-n", 4, (IMG, IMG)), ("maf-yolo-s", 2, (IMG, IMG)),
                            ("maf-yolo-n", 2, (256, 64))):
        specs = parse_graph(MODEL_ZOO[name], nc=NC)[0]
        ev = Evaler(half=False, device=dev)
        ev.init_model(name, random_folded_variables(specs, seed=1), nc=NC, folded=True)
        fw = ev.fe_weights
        x = images(2, b, h, w).to(dev)
        want = FE.frontend_plain(x, fw)
        got32 = FE.frontend_forward(x, fw, torch.float32)
        got16 = FE.frontend_forward(x, fw, torch.bfloat16).float()
        torch.cuda.synchronize()
        e32 = (got32 - want).abs().max().item()
        e16 = (got16 - want).abs()
        tile, smem, threads = FE.frontend_plan(fw)
        emit(phase="frontend_check", model=name, shape=[b, h, w], tile=tile,
             smem_bytes=smem, threads=threads, max_abs_err_f32=e32, max_abs_err_bf16=e16.max().item(),
             mean_abs_err_bf16=e16.mean().item(), out_std=want.std().item())
        check(torch.allclose(got32, want, atol=1e-3, rtol=1e-3),
              f"frontend f32 kernel disagrees with plain ({name} {h}x{w}): {e32}")
        check(torch.allclose(got16, want, atol=0.05, rtol=0.05) and e16.mean().item() < 0.01,
              f"frontend bf16 kernel disagrees with plain ({name} {h}x{w})")
        fe_err.setdefault(name, e16.max().item())

    # ---- 4. NMS kernel vs plain
    rng = np.random.default_rng(3)
    nms_inputs, nms_err = {}, 0.0
    for m in (512, 2000):
        xy = rng.uniform(0, 400, (BATCH, m, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + rng.uniform(10, 120, (BATCH, m, 2))], -1)
        bt = torch.from_numpy(boxes.astype(np.float32)).to(dev)
        vt = torch.from_numpy(rng.uniform(0, 1, (BATCH, m)) > 0.1).to(dev)
        got, want = G.greedy_nms(bt, vt, 0.65), G.greedy_nms_plain(bt, vt, 0.65)
        mismatch = int((got != want).sum().item())
        nms_err = max(nms_err, (got.float() - want.float()).abs().max().item())
        emit(phase="nms_check", m=m, batch=BATCH, kept=int(want.sum().item()),
             valid=int(vt.sum().item()), mismatches=mismatch)
        check(mismatch == 0, f"greedy_nms kernel keep set differs at M={m}: {mismatch}")
        nms_inputs[m] = (bt, vt)

    # ---- 5. dw_grad kernel vs plain
    dk_err = dw_grad_phase(dev)

    # ---- 6. slice
    # Random weights with gain 1.5 keep activations image-dependent through
    # the 34 layers. Random heads are not peaky: an anchor whose feature is
    # large lights up many classes, and one anchor with more than two
    # classes above threshold sends its whole batch to the dense path
    # (nms.py's fast-path condition). So each head level keeps two live
    # classes (2l, 2l+1); their cls_pred rows are recentred and scaled,
    # logit' = a*(W f - mu_c) + c, from 4 calibration images, so that about
    # 150 pairs per image clear conf 0.03, and thr_over lets about 2500
    # through, which overflows compact_k = 512. The other classes get a bias
    # of -30 and never fire.
    specs = parse_graph(MODEL_ZOO["maf-yolo-n"], nc=NC)[0]
    folded = random_folded_variables(specs, seed=0, weight_gain=1.5)
    net = folded["params"]["net"]
    head_layers = (31, 32, 33)
    cal = models(folded, False, dev).forward(images(10, 4).to(dev))
    live = []
    for lvl, (i, o) in enumerate(zip(head_layers, cal)):
        cls = list(range(2 * lvl, 2 * lvl + 2))
        zl = torch.logit(o[1].double().clamp(1e-12, 1 - 1e-12)).reshape(4, -1, NC)[..., cls]
        zl = zl - torch.from_numpy(net[f"layer{i}"]["cls_pred"]["bias"][cls]).to(dev)
        mu = zl.mean((0, 1))
        live.append((i, cls, mu, zl - mu))
    a = 2.5 / torch.cat([d.flatten() for *_, d in live]).std().item()
    q = (a * torch.cat([d.flatten() for *_, d in live])).sort(descending=True).values
    c = float(np.log(0.03 / 0.97)) - q[150 * 4].item()
    thr_over = float(1 / (1 + np.exp(-(q[2500 * 4].item() + c))))
    for i, cls, mu, _ in live:
        pred = net[f"layer{i}"]["cls_pred"]
        bias = np.full(NC, -30.0, np.float32)
        bias[cls] = c - a * mu.cpu().numpy()
        pred["kernel"] = pred["kernel"] * a
        pred["bias"] = bias
    ev = models(folded, True, dev)
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
    launches = {"frontend": FE.frontend_forward.launches, "greedy_nms": G.greedy_nms.launches}
    fast = sum(n == 1 for n in nms_per_batch)
    emit(phase="slice_run", batches=BATCHES + 1, launches=launches,
         fast_path_batches=fast, overflow_nms_launches=launches["greedy_nms"] - nms_before,
         dets_per_image_mean=float(torch.cat([o["valid"].sum(1) for o in outs]).float()
                                   .mean().item()),
         overflow_dets_per_image_mean=float(over["valid"].sum(1).float().mean().item()))
    check(launches["frontend"] == BATCHES + 1, f"front-end kernel launches {launches}")
    check(launches["greedy_nms"] > 0 and fast > 0, f"NMS kernel launches {launches}")
    check(launches["greedy_nms"] - nms_before == -(-2000 // 256),
          "overflow batch did not take the dense path's blocked NMS")
    for o in outs + [over]:
        v = o["valid"]
        check(o["boxes"].shape == (BATCH, 300, 4) and bool(torch.isfinite(o["boxes"]).all())
              and bool(torch.isfinite(o["scores"]).all()), "non-finite or misshaped output")
        check(int(v.sum(1).min()) > 0, "an image has no detection")
        s = torch.where(v, o["scores"], torch.zeros_like(o["scores"]))
        check(bool((s[:, 1:] <= s[:, :-1]).all()), "scores not descending")

    # card f32 vs CPU plain versions, 2 images @640
    gpu32, cpu32 = models(folded, False, dev), models(folded, False, "cpu")
    two = images(7, 2)
    g = {k: v.cpu() for k, v in gpu32.predict(two.to(dev)).items()}
    r = cpu32.predict(two)
    n_ref = matched = 0
    for i in range(2):
        sel = r["valid"][i] & (r["scores"][i] > 0.1)
        gv = g["valid"][i]
        iou = box_iou_pairwise(r["boxes"][i][sel], g["boxes"][i][gv])
        same = ((r["classes"][i][sel][:, None] == g["classes"][i][gv][None])
                & ((r["scores"][i][sel][:, None] - g["scores"][i][gv][None]).abs() <= 0.01)
                & (iou >= 0.9))
        n_ref += int(sel.sum())
        matched += int(same.any(1).sum())
    frac = matched / max(n_ref, 1)
    emit(phase="slice_check", cpu_dets_above_0p1=n_ref, matched=matched, fraction=frac)
    check(n_ref >= 10 and frac >= 0.95, f"card vs CPU: {matched}/{n_ref} detections matched")

    # ---- 7. timings (CUDA events, after warm-up)
    x = batches[0]
    e2e_ms = events_ms(lambda: ev.predict(x), iters=BATCHES)
    lat = []
    for bt in batches:
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_.record()
        ev.predict(bt)
        e_.record()
        torch.cuda.synchronize()
        lat.append(s_.elapsed_time(e_))
    y = FE.frontend_forward(x, ev.fe_weights, torch.bfloat16)
    heads = ev.model(y)
    stage = {
        "frontend_ms": events_ms(lambda: FE.frontend_forward(x, ev.fe_weights, torch.bfloat16), 10),
        "layers3_33_ms": events_ms(lambda: ev.model(y), 10),
        "decode_nms_ms": events_ms(lambda: fused_decode_nms(heads), 10),
    }
    emit(phase="timing_e2e", model="maf-yolo-n", dtype="bf16", batch=BATCH, img=IMG,
         img_per_s=BATCH / (e2e_ms / 1e3), batch_ms_mean=e2e_ms,
         p50_batch_ms=float(np.median(lat)), p90_batch_ms=float(np.percentile(lat, 90)),
         **stage)
    fe_ms = events_ms(lambda: FE.frontend_forward(x, ev.fe_weights, torch.bfloat16), 10)
    fe_plain_ms = events_ms(lambda: FE.frontend_plain(x, ev.fe_weights, torch.bfloat16), 10)
    nms_ms, nms_plain_ms = {}, {}
    for m, (bt, vt) in nms_inputs.items():
        nms_ms[m] = events_ms(lambda: G.greedy_nms(bt, vt, 0.65), 10)
        nms_plain_ms[m] = events_ms(lambda: G.greedy_nms_plain(bt, vt, 0.65), 3)
    emit(phase="timing_kernels", frontend_shape=[BATCH, IMG, IMG, 3],
         frontend_ms=fe_ms, frontend_plain_ms=fe_plain_ms,
         nms_ms=nms_ms, nms_plain_ms=nms_plain_ms)

    del ev, gpu32, cpu32, batches, outs
    torch.set_grad_enabled(True)
    train = train_phases(dev)
    dk_err = max(dk_err, train["dk_err"])

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "frontend", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/frontend.cu",
         "replaces": "mafyolo_tpu/ops/frontend_pallas.py:467",
         "launches": launches["frontend"], "max_abs_err": fe_err["maf-yolo-n"],
         "ms": fe_ms, "plain_ms": fe_plain_ms},
        {"name": "greedy_nms", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "mafyolo_tpu/ops/pallas_nms.py:60",
         "launches": launches["greedy_nms"], "max_abs_err": nms_err,
         "ms": nms_ms[512], "plain_ms": nms_plain_ms[512]},
        {"name": "dw_grad", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/dw_grad.cu",
         "replaces": "mafyolo_tpu/ops/dw_grad_pallas.py:143 and :47",
         "launches": train["launches"], "max_abs_err": dk_err,
         "ms": train["dk_ms"], "plain_ms": train["dk_plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def _leaf_errors(got, want, floor=1e-2):
    """Largest |got - want| of each leaf over max(max|want leaf|, floor * the
    largest leaf magnitude); got and want map names to tensors."""
    top = max(w.abs().max().item() for w in want.values())
    return {k: (got[k].float().cpu() - w.float().cpu()).abs().max().item()
            / max(w.abs().max().item(), floor * top) for k, w in want.items()}


def train_phases(dev):
    """Phases 8-11: the train path on the card. Returns the dw_grad launches of
    the train run, the summed dk ms per step, kernel and plain, and the
    kernel's largest error at B=32."""
    import numpy as np
    import torch

    from mafyolo_tpu_torch.core.engine import Trainer, load_config
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    from mafyolo_tpu_torch.models import build_model
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mafyolo_tpu_torch.ops import dw_grad as DG
    from mafyolo_tpu_torch.ops import frontend as FE
    from mafyolo_tpu_torch.ops import greedy_nms as G
    from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                                state_dict_to_train_variables,
                                                train_variables_to_state_dict)
    cl = torch.channels_last

    # ---- 8. train: N bs32@640 bf16 through the engine loop
    cfg = load_config(os.path.join(HERE, "configs", "maf_yolo_n.py"))
    torch.manual_seed(0)
    model = build_model("maf-yolo-n", nc=NC).to(dev).to(memory_format=cl)
    sites = dw_sites(model, IMG, dev)
    tr = Trainer(model, cfg, nc=NC, img_size=IMG, batch_size=BATCH, epochs=300,
                 max_stepnum=STEPS_PER_EPOCH, dtype=torch.bfloat16)
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
    metrics = (tr.train_one_epoch(2, batches[:TRAIN_STEPS], mark=mark)
               + tr.train_one_epoch(3, batches[TRAIN_STEPS:], mark=mark))
    torch.cuda.synchronize()
    launches = DG.dw_grad.launches
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    ema_moved = sum(not torch.equal(v, ema0[k]) for k, v in tr.state.ema.state_dict().items())
    emit(phase="train", model="maf-yolo-n", dtype="bf16", batch=BATCH, img=IMG,
         steps=len(metrics), epochs=[2, 3], use_atss=[True, False],
         accumulate=tr.plan(0, 2)[0]["accumulate"], dw_sites=len(sites),
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

    # ---- 9. train_check: one f32 step, card (kernel) vs CPU (plain), bs2@160
    variables = random_train_variables(tr.state.model.specs, seed=3)
    imgs, targets = train_batch(7, 2, 160, dev)
    grads, comps, bn = {}, {}, {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        m = build_model("maf-yolo-n", nc=NC)
        m.load_state_dict(train_variables_to_state_dict(variables))
        m = m.to(where).to(memory_format=cl)
        st = init_train_state(m, weight_decay=5e-4)
        before = DG.dw_grad.launches
        met = make_train_step(num_classes=NC, img_size=160)(
            st, imgs.to(where), targets.to(where), 0.01, 0.01, 0.01, 0.9, False, False)
        if key == "card":
            check(DG.dw_grad.launches - before == len(sites), "train_check: dw_grad not launched")
        comps[key] = {k: float(v) for k, v in met.items()}
        grads[key] = {n: p.grad for n, p in m.named_parameters()}
        bn[key] = {n: b for n, b in m.named_buffers()}
    g_err = _leaf_errors(grads["card"], grads["cpu"])
    s_err = _leaf_errors(bn["card"], bn["cpu"])
    l_err = max(abs(comps["card"][k] - v) / max(abs(v), 1e-6) for k, v in comps["cpu"].items())
    worst = sorted(g_err.items(), key=lambda kv: -kv[1])[:3]
    emit(phase="train_check", batch=2, img=160, dtype="f32", loss_cpu=comps["cpu"],
         loss_card=comps["card"], loss_rel_err=l_err, grad_leaves=len(g_err),
         grad_max_rel_err=max(g_err.values()), grad_worst=worst,
         bn_stats_max_rel_err=max(s_err.values()),
         tolerance="loss components rel 1e-3; each gradient and BN buffer: "
                   "max|card - cpu| <= 1e-2 * max(max|cpu leaf|, 1e-2 * max over leaves)")
    check(l_err <= 1e-3, f"train_check loss components differ: {comps}")
    check(max(g_err.values()) <= 1e-2, f"train_check gradients differ: {worst}")
    check(max(s_err.values()) <= 1e-2, "train_check BN running stats differ")
    del grads, bn

    # ---- 10. train_to_serve: fold the EMA, predict on the card
    ema_vars = state_dict_to_train_variables(tr.state.ema.state_dict())
    ev = Evaler(half=True, device=dev)
    ev.init_model("maf-yolo-n", ema_vars, nc=NC, folded=False)
    FE.frontend_forward.launches = G.greedy_nms.launches = 0
    out = ev.predict(batches[0][0])
    torch.cuda.synchronize()
    serve_launches = {"frontend": FE.frontend_forward.launches, "greedy_nms": G.greedy_nms.launches}
    # After 4 optimizer steps the EMA's preds are still near their zero
    # init, so every score sits near the prior (0.01) and few or no boxes
    # clear conf 0.03. So the fold is checked on raw outputs: the folded
    # model in f32 (front-end kernel included) against the train form in
    # eval mode on the same EMA weights, 4 images, at every head's stem
    # (feat), cls_proj and reg_proj output and its cls and reg.
    ev32 = Evaler(half=False, device=dev)
    ev32.init_model("maf-yolo-n", ema_vars, nc=NC, folded=False)
    ref = build_model("maf-yolo-n", nc=NC)
    ref.load_state_dict(train_variables_to_state_dict(ema_vars))
    ref = ref.to(dev).to(memory_format=cl).eval()

    def inner(model, run):
        got, hooks = {}, []
        for name, m in model.named_modules():
            if name.endswith(("cls_proj", "reg_proj")):
                hooks.append(m.register_forward_hook(
                    lambda mod, a, o, name=name: got.__setitem__(name, o)))
        with torch.no_grad():
            for lvl, outs in enumerate(run()):
                got.update({f"level{lvl}.{t}": o for t, o in zip(("feat", "cls", "reg"), outs)})
        for h in hooks:
            h.remove()
        return got

    four = batches[0][0][:4]
    got = inner(ev32.model, lambda: ev32.forward(four))
    want = inner(ref, lambda: ref(four.flip(-1).float() / 255.0))
    check(got.keys() == want.keys() and len(want) == 15, "train_to_serve: outputs differ in kind")
    fold_err = {k: (got[k].float() - w).abs().max().item() / w.abs().max().item()
                for k, w in want.items()}
    emit(phase="train_to_serve", launches=serve_launches,
         dets_per_image_mean=float(out["valid"].sum(1).float().mean().item()),
         max_score=max(o[1].float().max().item() for o in ev.forward(four)),
         fold_outputs=len(fold_err), fold_max_rel_err=max(fold_err.values()),
         fold_worst=sorted(fold_err.items(), key=lambda kv: -kv[1])[:3],
         tolerance="folded f32 vs train form eval f32: max|err| <= 1e-3 * max|train form| "
                   "for each output")
    check(serve_launches["frontend"] == 1 and serve_launches["greedy_nms"] >= 1,
          "train_to_serve: front-end or NMS kernel not launched")
    check(out["boxes"].shape == (BATCH, 300, 4) and bool(torch.isfinite(out["boxes"]).all())
          and bool(torch.isfinite(out["scores"]).all()), "train_to_serve: bad output")
    check(max(fold_err.values()) <= 1e-3, f"train_to_serve: folded model differs from the "
                                          f"train form: {fold_err}")
    del ev, ev32, ref, got, want

    # ---- 11. timing_train: CUDA events per stage over steady steps
    stages = ("forward", "loss", "backward", "optimizer")
    timed = []

    def mark_t(stage):
        ev_ = torch.cuda.Event(enable_timing=True)
        ev_.record()
        timed[-1][stage] = ev_

    tr.train_one_epoch(4, batches[:2])                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    for i, (im, tg) in enumerate(batches[2:8]):
        sched, do_apply = tr.plan(2 + i, 4)
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
            sched, do_apply = tr.plan(8 + i, 4)
            tr.train_step(tr.state, im, tg, sched["lr_bnw"], sched["lr_weight"],
                          sched["lr_bias"], sched["momentum"], do_apply, False)
        p1.record()
        torch.cuda.synchronize()
    prof_ms = p0.elapsed_time(p1)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 2e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit(phase="profile_train", steps=2, step_ms_profiled=prof_ms / 2,
         device_busy_ms_per_step=busy_us / 2e3, idle_share=1 - busy_us / 1e3 / prof_ms,
         device_ops_per_step=len(spans) / 2,
         top_ms_per_step=[[n[:100], t] for n, t in top])
    check(busy_us > 0, "profile_train: the profiler saw no device activity")

    # the dw_grad kernel against its plain version at every site at B=32
    # (up to 819 200 terms per tap, several tiles per block, the path's
    # n_split), then the summed dk time per step, kernel against plain
    dk_ms = dk_plain_ms = b32_err = b32_rel = 0.0
    for c, h, w, k, pad, dil in sites:
        gen = torch.Generator(device=dev).manual_seed(c + h + k)
        # an offset keeps x nonzero at every border
        x = (torch.randn((BATCH, c, h, w), generator=gen, device=dev) + 0.5) \
            .to(torch.bfloat16).contiguous(memory_format=cl)
        g = torch.randn((BATCH, c, h, w), generator=gen, device=dev).to(torch.bfloat16) \
            .contiguous(memory_format=cl)
        before = DG.dw_grad.launches
        got = DG.dw_grad(x, g, k, pad, dil)
        want = DG.dw_grad_plain(x, g, k, pad, dil)
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        check(err <= 1e-3 * scale, f"dw_grad kernel vs plain at B={BATCH} C{c} H{h} k{k}: "
                                   f"{err} > 1e-3 * {scale}")
        check(torch.equal(got, DG.dw_grad(x, g, k, pad, dil)),
              f"dw_grad not deterministic at B={BATCH} C{c} H{h} k{k}")
        b32_err, b32_rel = max(b32_err, err), max(b32_rel, err / scale)
        dk_ms += events_ms(lambda: DG.dw_grad(x, g, k, pad, dil), iters=5)
        dk_plain_ms += events_ms(lambda: DG.dw_grad_plain(x, g, k, pad, dil), iters=2, warmup=1)
        DG.dw_grad.launches = before       # check and timing launches are not the path's
    emit(phase="dw_grad_check_b32", sites=len(sites), batch=BATCH, dtype="bf16",
         max_abs_err=b32_err, max_rel_err=b32_rel,
         tolerance="1e-3 * max|plain| at each site; bit-identical on a second launch")
    emit(phase="timing_train", model="maf-yolo-n", dtype="bf16", batch=BATCH, img=IMG,
         steps=len(step_ms), img_per_s=BATCH / (mean_ms / 1e3), step_ms_mean=mean_ms,
         apply_step_ms=float(np.mean([m for m, a in step_ms if a])),
         accumulate_step_ms=float(np.mean([m for m, a in step_ms if not a])),
         **{f"{s_}_ms": float(np.mean(v)) for s_, v in per.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         dk_sites=len(sites), dk_kernel_ms_per_step=dk_ms, dk_plain_ms_per_step=dk_plain_ms)
    return {"launches": launches, "dk_ms": dk_ms, "dk_plain_ms": dk_plain_ms,
            "dk_err": b32_err}


if __name__ == "__main__":
    main()
