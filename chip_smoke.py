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
  5. slice      MAF-YOLO-N deploy Evaler.predict in bf16, bs32 uint8 @640,
                for BATCHES batches plus one batch that overflows into the
                dense NMS path, with every kernel's launch count read around
                that run; then the card in f32 against the CPU plain path on
                2 images @640;
  6. timings    CUDA-event times: e2e img/s and p50 batch latency at bs32@640
                and each kernel beside its plain version at main-path shapes.
Weights are random (seeded); the cls_pred layers are rescaled so that an
image has about 150 (anchor, class) pairs above conf 0.03. Nothing here
imports JAX. The last line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, IMG, BATCHES, NC = 32, 640, 20, 80


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

    # ---- 2. build
    for name in ("frontend", "greedy_nms"):
        t0 = time.perf_counter()
        path = _build.build(name)
        secs, log = _build.BUILD_LOG.get(name, (time.perf_counter() - t0, ""))
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit(phase="build", kernel=name, seconds=secs, lib=os.path.relpath(path, HERE),
             ptxas=ptxas)

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

    # ---- 5. slice
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

    # ---- 6. timings (CUDA events, after warm-up)
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

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "frontend", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/frontend.cu",
         "replaces": "mafyolo_tpu/ops/frontend_pallas.py:466",
         "launches": launches["frontend"], "max_abs_err": fe_err["maf-yolo-n"],
         "ms": fe_ms, "plain_ms": fe_plain_ms},
        {"name": "greedy_nms", "route": "cuda", "source": "mafyolo_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "mafyolo_tpu/ops/pallas_nms.py:60",
         "launches": launches["greedy_nms"], "max_abs_err": nms_err,
         "ms": nms_ms[512], "plain_ms": nms_plain_ms[512]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
