"""Seeded inputs, weights and yardsticks that chip_smoke.py, the tuning tool
and the card's tests share: images, eval and train sets held in memory
(ArrayDataset: the card's machine has no image decoder), an Evaler on random
deploy weights whose heads give detections, the depthwise sites of a train
graph with inputs for each, aten's weight gradient of the same conv (timed
beside the dw_grad kernel, never called by the port), the NMS kernel's
timing inputs, and a train-form tree written out under the reference's
state_dict keys (the inverse of utils/torch_bridge.py, for `.pt` files made
from random weights)."""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.data.datasets import DetectionDataset
from mafyolo_tpu_torch.models.blocks import DWConv, bepc3_chain_len
from mafyolo_tpu_torch.models.graph import parse_graph
from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
from mafyolo_tpu_torch.ops import greedy_nms as G
from mafyolo_tpu_torch.ops import nms as NMS
from mafyolo_tpu_torch.utils.bridge import random_folded_variables

NC, IMG = 80, 640
L2_BYTES = 50 << 20        # the H100's L2 cache


def images(seed, b, h=IMG, w=IMG):
    """uint8 BGR images [b,h,w,3] from a seed, on the CPU."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, h, w, 3), dtype=np.uint8))


class ArrayDataset(DetectionDataset):
    """The port's DetectionDataset over images held in memory. Its first
    argument, in place of an image directory, is {"images": [uint8 BGR HWC
    arrays], "labels": [(n, 5) cls + normalized xywh arrays]}; image i is
    named f"{i:06d}.bmp", so its image_id is i. Only the label scan and
    load_image are its own: letterbox, rect sorting, get_sample, coco_gt,
    image_id and the loader are the dataset's. Images are held at their
    load size (long side img_size or test_load_size): nothing is resized."""

    def _load_labels(self):
        imgs = self.img_dir["images"]
        self.img_paths = [f"{i:06d}.bmp" for i in range(len(imgs))]
        shapes = np.array([(im.shape[1], im.shape[0]) for im in imgs], np.float64)
        labels = [np.asarray(lb, np.float32).reshape(-1, 5) for lb in self.img_dir["labels"]]
        return labels, [[] for _ in imgs], shapes

    def load_image(self, index, force_load_size=None):
        im = self.img_dir["images"][int(Path(self.img_paths[index]).stem)]
        h0, w0 = im.shape[:2]
        if max(h0, w0) != (force_load_size or self.img_size):
            raise ValueError(f"ArrayDataset holds images at their load size, not {h0}x{w0}")
        return im, (h0, w0), (h0, w0)


def eval_set(seed, sizes, nc=NC, max_boxes=30):
    """{"images", "labels"} for ArrayDataset: an image of each (h, w) in
    sizes, seeded uniform bytes with 1..max_boxes filled rectangles of
    random classes, each labelled with its rectangle, then +-8 of noise a
    pixel (as tests/helpers.py:make_synth_dataset textures its images: no
    flat region, so no two anchors tie)."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (nc, 3), dtype=np.uint8)
    images, labels = [], []
    for h, w in sizes:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n = int(rng.integers(1, max_boxes + 1))
        cls = rng.integers(0, nc, n)
        bw, bh = rng.integers(w // 16, w // 3, n), rng.integers(h // 16, h // 3, n)
        x1, y1 = rng.integers(0, w - bw), rng.integers(0, h - bh)
        for c, x, y, bx, by in zip(cls, x1, y1, bw, bh):
            img[y:y + by, x:x + bx] = palette[c]
        img = np.clip(img.astype(np.int16) + rng.integers(-8, 9, (h, w, 3)), 0, 255)
        images.append(img.astype(np.uint8))
        labels.append(np.stack([cls, (x1 + bw / 2) / w, (y1 + bh / 2) / h, bw / w, bh / h],
                               1).astype(np.float32))
    return {"images": images, "labels": labels}


def train_set(seed, n, size=IMG, nc=NC):
    """{"images", "labels"} for ArrayDataset: n square images of `size`
    made as eval_set makes them (1-30 labelled rectangles each, textured),
    the train set of the card's trainer runs."""
    return eval_set(seed, [(size, size)] * n, nc=nc)


# The learnable set's classes, one BGR colour each (tests/helpers.py:COLORS)
SYNTH_COLORS = ((40, 40, 220), (40, 220, 40), (220, 40, 40))
# h / w of its val images, at long side IMG: square, 4:3 and 16:9 either way up
SYNTH_VAL_RATIOS = (1.0, 0.75, 4 / 3, 9 / 16, 16 / 9)


def synth_set(seed, sizes, max_objects=4, noise=6):
    """{"images", "labels"} for ArrayDataset: the learnable synthetic set of
    tests/helpers.py:make_synth_dataset (the set the JAX package's Trainer
    tests and its overfit run train on), made in memory. An image of each
    (h, w) in sizes: a grey 90-130 background, 1..max_objects filled
    rectangles with sides from 1/8 to 1/3 of the image's, each of a random
    class of SYNTH_COLORS and labelled with its rectangle (a later one may
    cover an earlier one, as there), then +-noise a pixel, so that no flat
    region makes two anchors tie. Drawn with numpy slices (the rectangle
    covers x1..x1+bw-1), not cv2, and held as arrays with no JPEG round
    trip: the card's machine has neither cv2 nor an image encoder."""
    rng = np.random.default_rng(seed)
    nc = len(SYNTH_COLORS)
    images, labels = [], []
    for h, w in sizes:
        img = rng.integers(90, 130, (h, w, 3)).astype(np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            c = int(rng.integers(0, nc))
            bw, bh = int(rng.integers(w // 8, w // 3)), int(rng.integers(h // 8, h // 3))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y1:y1 + bh, x1:x1 + bw] = SYNTH_COLORS[c]
            rows.append([c, (x1 + bw / 2) / w, (y1 + bh / 2) / h, bw / w, bh / h])
        if noise:
            img = np.clip(img.astype(np.int16) + rng.integers(-noise, noise + 1, (h, w, 3)),
                          0, 255).astype(np.uint8)
        images.append(img)
        labels.append(np.array(rows, np.float32).reshape(-1, 5))
    return {"images": images, "labels": labels}


def synth_val_sizes(seed, n, size=IMG):
    """n (h, w) at long side `size`, each of a ratio of SYNTH_VAL_RATIOS drawn
    from a seed, so that rect batches take several shapes."""
    pick = np.random.default_rng(seed).integers(0, len(SYNTH_VAL_RATIOS), n)
    return [(size, round(size / r)) if r >= 1 else (round(size * r), size)
            for r in np.asarray(SYNTH_VAL_RATIOS)[pick]]


def train_batch(seed, b, img, device, max_boxes=120, nc=NC):
    """uint8 BGR images [b,img,img,3] and padded targets [b,max_boxes,5]
    (1-30 boxes per image: cls, cx, cy, w, h normalized; pad rows cls -1),
    made on the device from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.randint(0, 256, (b, img, img, 3), generator=gen, device=device,
                         dtype=torch.uint8)
    u = torch.rand((b, max_boxes, 5), generator=gen, device=device)
    n = torch.randint(1, 31, (b, 1), generator=gen, device=device)
    real = torch.arange(max_boxes, device=device)[None, :] < n
    wh = 0.03 + 0.5 * u[..., 3:5]
    xy = wh / 2 + u[..., 1:3] * (1 - wh)
    cls = (u[..., 0] * nc).floor().clamp(max=nc - 1)
    t = torch.cat([cls[..., None], xy, wh], -1)
    t = torch.where(real[..., None], t, torch.zeros_like(t))
    t[..., 0] = torch.where(real, t[..., 0], -1.0)
    return imgs, t


def labels_from_detections(preds, dataset, min_score=0.1, max_per_class=100):
    """Labels for dataset's images (in image-id order, as eval_set gives
    them) made from an eval loop's COCO-format detections: those with score
    > min_score, the best max_per_class of each class in an image (what
    COCOEvaluator's maxDets of 100 keeps), as normalized xywh in native
    image space. Scored against them, the same detections give AP 1: every
    detection that COCOEvaluator keeps and that outscores a label is one."""
    wh = {dataset.image_id(i): dataset.shapes[i] for i in range(len(dataset))}
    rows = {i: [] for i in wh}
    per_class = {}
    for d in sorted(preds, key=lambda d: -d["score"]):
        key = (d["image_id"], d["category_id"])
        if d["score"] > min_score and per_class.get(key, 0) < max_per_class:
            per_class[key] = per_class.get(key, 0) + 1
            x, y, bw, bh = d["bbox"]
            w, h = wh[d["image_id"]]
            rows[d["image_id"]].append([d["category_id"], (x + bw / 2) / w, (y + bh / 2) / h,
                                        bw / w, bh / h])
    return [np.array(rows[i], np.float32).reshape(-1, 5) for i in sorted(rows)]


def evaler(name, folded, half, device):
    """An Evaler of `name` (a zoo name or a graph dict) on the folded tree,
    NC classes."""
    ev = Evaler(half=half, device=device)
    ev.init_model(name, folded, nc=NC, folded=True)
    return ev


def random_deploy(name, dev, weight_gain=1.5):
    """Random folded weights (seed 0, gain 1.5) whose heads give detections;
    `name` is a zoo name or a graph dict (an office graph, models/office.py).

    Gain 1.5 keeps activations image-dependent through the 34 layers. Random
    heads are not peaky: an anchor whose feature is large lights up many
    classes, and one anchor with more than two classes above threshold sends
    its whole batch to the dense path (nms.py's fast-path condition). So each
    head level keeps two live classes (2l, 2l+1); their cls_pred rows are
    recentred and scaled, logit' = a*(W f - mu_c) + c, from 4 calibration
    images, so that about 150 pairs per image clear conf 0.03. Returns the
    tree and the conf at which about 2500 pairs per image pass, which
    overflows compact_k = 512. The other classes get a zero kernel and a bias
    of -30, and never fire."""
    specs, _, head_layers = parse_graph(MODEL_ZOO[name] if isinstance(name, str) else name,
                                        nc=NC)
    folded = random_folded_variables(specs, seed=0, weight_gain=weight_gain)
    net = folded["params"]["net"]
    cal = evaler(name, folded, False, dev).forward(images(10, 4).to(dev))
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
        kernel = np.zeros_like(pred["kernel"])
        kernel[..., cls] = pred["kernel"][..., cls] * a
        pred["kernel"], pred["bias"] = kernel, bias
    return folded, thr_over


def dw_sites(model, img, device):
    """[(C, H, W, k, pad, dilation)] of every depthwise conv of a train-form
    model at img x img, read from one forward (a dw_grad launch each per
    backward)."""
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


def deploy_dw_sites(name, img, device):
    """[((C, H, W, k, act), count, front_end)] of the depthwise convs of a
    deploy model's forward at img x img, in the order first met: every
    ConvAct whose conv is depthwise, act the activation it fuses, front_end
    whether its layer is one of 0-2 (which the front-end kernel runs on a
    predict whose sides are multiples of 4)."""
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.blocks import ConvAct
    model = build_model(name, nc=NC, deploy=True).to(device).eval()
    sites, hooks = {}, []

    def keep(mod, args, front):
        c = args[0].shape[1]
        key = (c, args[0].shape[2], args[0].shape[3], mod.conv.kernel_size[0], mod.act)
        count, _ = sites.get(key, (0, front))
        sites[key] = (count + 1, front)
    for mname, m in model.named_modules():
        if isinstance(m, ConvAct) and 1 < m.conv.groups == m.conv.in_channels:
            front = int(mname.split(".")[1][len("layer"):]) <= 2
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, front=front: keep(mod, args, front)))
    with torch.no_grad():
        model(torch.zeros(1, img, img, 3, device=device))
    for h in hooks:
        h.remove()
    return [(key, count, front) for key, (count, front) in sites.items()]


def dw_site_inputs(site, batch, dev):
    """bf16 channels-last x (offset 0.5: nonzero at every border) and g."""
    c, h, w, k, pad, dil = site
    gen = torch.Generator(device=dev).manual_seed(c + h + k)
    ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
    x = (torch.randn((batch, c, h, w), generator=gen, device=dev) + 0.5) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    g = torch.randn((batch, c, ho, wo), generator=gen, device=dev).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    return x, g


def dw_library(x, k, pad, dil):
    """fn(x, g): one call of aten's weight gradient of the depthwise conv that
    x [B,C,H,W] goes through (a yardstick; the port never calls it)."""
    c = x.shape[1]
    wk = torch.zeros((c, 1, k, k), dtype=x.dtype, device=x.device)
    return lambda x, g: torch.ops.aten.convolution_backward(
        g, x, wk, None, [1, 1], [pad, pad], [dil, dil], False, [0, 0], c,
        [False, True, False])


def cold_sets(tensors, l2_bytes=L2_BYTES):
    """[tensors, copies of them, ...]: enough sets that a pass over all of
    them moves more than twice the L2 cache, so a call that takes the sets in
    turn finds none of its input there (one set when the tensors alone are
    that large). A copy keeps its tensor's strides: a channel slice stays a
    slice, its pixel pitch part of what is timed."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, -(-2 * l2_bytes // nbytes))
    return [tuple(tensors)] + [tuple(torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                         device=t.device).copy_(t)
                                     for t in tensors) for _ in range(n - 1)]


def int8_silu_every_bf16(dev, k=1):
    """The int8 conv's fused SiLU epilogue on every finite bf16 value (a k x k
    conv, 1 for the windowed kernel, 3 for the 3x3 stride-1 one, whose scale
    is 0 and whose bias holds the values) against torch's bf16 SiLU:
    (values, how many differ)."""
    import dataclasses

    from mafyolo_tpu_torch.ops import quant_conv as QC
    vals = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    vals = vals.float()[torch.isfinite(vals.float())]
    w = torch.randn((vals.numel(), 16, k, k), generator=torch.Generator().manual_seed(13))
    p = QC.pack(w, torch.zeros(vals.numel()), torch.tensor(1.0), 1, k // 2, 1).to(dev)
    p = dataclasses.replace(p, scale=torch.zeros_like(p.scale), bias=vals.to(dev))
    x = torch.ones((1, 16, 1, 1), device=dev, dtype=torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    got = QC.int8_conv(x, p, "silu").flatten()
    want = torch.nn.functional.silu(vals.to(dev, torch.bfloat16))
    return vals.numel(), int((got != want).sum())


# Activation amaxes the quantizer check runs at: a typical one, small and
# large ones, one whose scale is no simple fraction, and the floor 1e-12.
QUANT_CHECK_AMAX = (2.5, 0.0123, 7.77, 333.3, 1e-12)


def int8_quant_every_bf16(dev):
    """The 3x3 stride-1 kernel's quantizer (csrc/int8_conv3x3.cuh: Quant,
    which its 16-byte loads take) against the plain version's: a 3x3 conv of
    16 input channels whose output channel o is 127 times the quantized
    centre pixel of input channel o (bijective in it), over one 64 x 64 image
    holding every finite bf16 value in its 16 channels (the others 0), and
    over f32 images of the values next to each half-integer multiple of the
    scale (the rounding's edges: 0-3 ulps either side of (k + 1/2) x_scale
    for k in -130..129, padded with zeros to whole pixels), at each of
    QUANT_CHECK_AMAX, bit for bit -> (values checked, how many outputs
    differ). On a CUDA device every probe is first asserted to take the
    16-byte loads (ops/quant_conv.py:load_path3x3)."""
    from mafyolo_tpu_torch.ops import quant_conv as QC
    c = 16
    w = torch.zeros((c, c, 3, 3))
    w[torch.arange(c), torch.arange(c), 1, 1] = 1.0
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    every = torch.where(torch.isfinite(every.float()), every, torch.zeros_like(every))
    checked = differ = 0
    for amax in QUANT_CHECK_AMAX:
        p = QC.pack(w, torch.zeros(c), torch.tensor(amax), 1, 1, 1).to(dev)
        xs = torch.tensor(p.x_scale, dtype=torch.float32)
        half = (torch.arange(-130, 130, dtype=torch.float32) + 0.5) * xs
        edge = [half]
        for _ in range(3):
            edge = [torch.nextafter(edge[0], torch.tensor(-math.inf))] + edge + \
                [torch.nextafter(edge[-1], torch.tensor(math.inf))]
        edge = torch.cat(edge)
        edge = torch.cat([edge, torch.zeros(-edge.numel() % (6 * c))])
        for vals, h in ((every, 64), (edge, 6)):
            # NHWC: pixel p's channel o holds value c p + o
            x = vals.reshape(1, h, -1, c).permute(0, 3, 1, 2).to(dev)
            if x.device.type == "cuda":
                assert QC.load_path3x3(x) == 0, "the quantizer probe missed the 16-byte loads"
            got, want = QC.int8_conv(x, p), QC.int8_conv_plain(x, p)
            checked += vals.numel()
            differ += int((got != want).sum())
    return checked, differ


def train_state_leaves(state):
    """Every leaf a train step moves, as CPU copies by name: the model's
    state dict (params and BN running statistics), the EMA's, the momentum
    buffers by parameter name and Wise-IoU's running mean."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    leaves = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    leaves.update({f"ema/{k}": v for k, v in state.ema.state_dict().items()})
    leaves.update({f"momentum/{names[id(p)]}": s["momentum_buffer"]
                   for p, s in state.optimizer.state.items()})
    leaves["wiou_mean"] = state.wiou_mean
    return {k: v.detach().cpu().clone() for k, v in leaves.items()}


def state_gate(ref, again, got, floor=1e-2):
    """The rematerialization gate over train_state_leaves: `ref` and `again`
    are two runs of the same steps from one state without remat (the card's
    run-to-run spread: cuDNN's backward may sum with atomics), `got` the
    run under remat. A leaf bit-equal in ref and again must be bit-equal in
    got; any other may sit off ref by at most twice the spread. A leaf's
    error is max|x - ref| / max(max|ref|, floor * the largest max|ref|).
    -> {"ok", "spread" (the largest error of again), "err" (of got), "worst"
    (got's three largest), "leaves", "leaves_equal_off" (bit-equal in ref
    and again), "leaves_equal_off_differing" (of those, not equal in got)}."""
    if not (ref.keys() == again.keys() == got.keys()):
        return {"ok": False, "keys_differ": sorted(set(ref) ^ set(got) | set(ref) ^ set(again))}
    top = max(v.float().abs().max().item() for v in ref.values() if v.numel())

    def errs(run):
        return {k: (run[k].float() - v.float()).abs().max().item()
                / max(v.float().abs().max().item(), floor * top)
                for k, v in ref.items() if v.numel()}
    spread, err = errs(again), errs(got)
    equal = [k for k in ref if torch.equal(ref[k], again[k])]
    differing = [k for k in equal if not torch.equal(ref[k], got[k])]
    worst_spread = max(spread.values())
    ok = not differing and all(e <= 2 * worst_spread for k, e in err.items()
                               if k not in equal)
    return {"ok": ok, "spread": worst_spread, "err": max(err.values()),
            "worst": sorted(err.items(), key=lambda kv: -kv[1])[:3], "leaves": len(ref),
            "leaves_equal_off": len(equal), "leaves_equal_off_differing": len(differing)}


def in_turn(fn, sets):
    """A call without arguments that runs fn(*sets[i]) for i = 0, 1, ... in turn."""
    state = {"i": 0}

    def run():
        args = sets[state["i"] % len(sets)]
        state["i"] += 1
        return fn(*args)
    return run


def random_boxes(rng, batch, m):
    """Score-ordered random boxes and a 90%-valid mask (few overlaps: most
    boxes are kept)."""
    xy = rng.uniform(0, 400, (batch, m, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(10, 120, (batch, m, 2))], -1)
    return boxes.astype(np.float32), rng.uniform(0, 1, (batch, m)) > 0.1


def capture_nms_inputs(predict):
    """The (boxes, valid, thr) of every greedy_nms call that predict() makes."""
    calls, real = [], NMS.greedy_nms

    def spy(boxes, valid, thr):
        calls.append((boxes.clone(), valid.clone(), thr))
        return real(boxes, valid, thr)
    NMS.greedy_nms = spy
    try:
        predict()
    finally:
        NMS.greedy_nms = real
    assert real is G.greedy_nms
    return calls


def _ref_bn(p, s, prefix, out):
    out[f"{prefix}.weight"], out[f"{prefix}.bias"] = p["scale"], p["bias"]
    out[f"{prefix}.running_mean"], out[f"{prefix}.running_var"] = s["mean"], s["var"]


def _ref_kernel(k):
    return np.ascontiguousarray(np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1)))


def _ref_convbn(p, s, prefix, out):
    out[f"{prefix}.conv.weight"] = _ref_kernel(p["conv"]["kernel"])
    _ref_bn(p["bn"], s["bn"], f"{prefix}.bn", out)


def _ref_repvgg(p, s, prefix, out, has_identity):
    _ref_convbn(p["dense"], s["dense"], f"{prefix}.rbr_dense", out)
    _ref_convbn(p["pw"], s["pw"], f"{prefix}.rbr_1x1", out)
    if has_identity:
        _ref_bn(p["idbn"], s["idbn"], f"{prefix}.rbr_identity", out)


def _ref_unireplk(p, s, prefix, out):
    drb, drs = p["drb"], s["drb"]
    out[f"{prefix}.dwconv.lk_origin.weight"] = _ref_kernel(drb["origin"]["conv"]["kernel"])
    _ref_bn(drb["origin"]["bn"], drs["origin"]["bn"], f"{prefix}.dwconv.origin_bn", out)
    for name in drb:
        if name.startswith("dil_k"):
            ks, r = name[len("dil_k"):].split("_r")
            out[f"{prefix}.dwconv.dil_conv_k{ks}_{r}.weight"] = _ref_kernel(
                drb[name]["conv"]["kernel"])
            _ref_bn(drb[name]["bn"], drs[name]["bn"], f"{prefix}.dwconv.dil_bn_k{ks}_{r}", out)
    _ref_bn(p["post_bn"], s["post_bn"], f"{prefix}.norm", out)


def _ref_bottlerep(p, s, prefix, out, basic):
    for name in ("conv1", "conv2"):
        if basic == "repvgg":
            _ref_repvgg(p[name], s[name], f"{prefix}.{name}", out, "idbn" in p[name])
        else:
            _ref_convbn(p[name]["block"], s[name]["block"], f"{prefix}.{name}.block", out)
    if "alpha" in p:
        out[f"{prefix}.alpha"] = p["alpha"]


def reference_state_dict(variables, specs, prefixes=None):
    """A train-form {'params','batch_stats'} tree (numpy, HWIO) -> the
    reference's state_dict of the same weights (OIHW, torch tensors): the
    inverse of utils/torch_bridge.py:convert_layer, with the reference's key
    quirks (rbr_identity only where cin == cout at stride 1,
    dil_conv_k{k}_{r} / dil_bn_k{k}_{r}, cls_conv_s / reg_conv_s, MPRep's
    conv1 / conv2, a ConvTranspose2d weight [I, O, kH, kW], the office head's
    per-role ModuleLists). Layer i's keys sit under 'backbone.{i}' or, with
    prefixes (models/office.py:OFFICE_TORCH_PREFIXES), under prefixes[i]."""
    params, stats = variables["params"]["net"], variables["batch_stats"]["net"]
    out = {}
    for spec in specs:
        name, kw = f"layer{spec.idx}", spec.kw
        if name not in params:
            continue
        pfx = prefixes[spec.idx] if prefixes else f"backbone.{spec.idx}"
        p, s = params[name], stats.get(name, {})
        if spec.kind in ("Conv", "SimConv"):
            _ref_convbn(p["block"], s["block"], pfx, out)
        elif spec.kind == "RepBlock":
            _ref_repvgg(p["conv1"], s["conv1"], f"{pfx}.conv1", out, kw["cin"] == kw["cout"])
            for i in range(kw["n"] - 1):
                _ref_repvgg(p[f"block{i}"], s[f"block{i}"], f"{pfx}.block.{i}", out, True)
        elif spec.kind == "BepC3":
            for cv in ("cv1", "cv2", "cv3"):
                _ref_convbn(p[cv], s[cv], f"{pfx}.{cv}", out)
            _ref_bottlerep(p["m_conv1"], s["m_conv1"], f"{pfx}.m.conv1", out, kw["basic"])
            for i in range(bepc3_chain_len(kw["n"]) - 1):
                _ref_bottlerep(p[f"m_block{i}"], s[f"m_block{i}"], f"{pfx}.m.block.{i}", out,
                               kw["basic"])
        elif spec.kind == "SimSPPF":
            for cv in ("cv1", "cv2"):
                _ref_convbn(p[cv], s[cv], f"{pfx}.{cv}", out)
        elif spec.kind == "Transpose":
            out[f"{pfx}.upsample_transpose.weight"] = np.ascontiguousarray(
                np.transpose(np.asarray(p["kernel"], np.float32), (2, 3, 0, 1)))
            out[f"{pfx}.upsample_transpose.bias"] = p["bias"]
        elif spec.kind == "Head_Effide":
            det, j = pfx.split(":")
            _ref_convbn(p["stem"], s["stem"], f"{det}.stems.{j}", out)
            for role in ("cls", "reg"):
                _ref_convbn(p[f"{role}_conv"], s[f"{role}_conv"], f"{det}.{role}_convs.{j}", out)
                out[f"{det}.{role}_preds.{j}.weight"] = _ref_kernel(p[f"{role}_pred"]["kernel"])
                out[f"{det}.{role}_preds.{j}.bias"] = p[f"{role}_pred"]["bias"]
        elif spec.kind == "ConvWrapper":
            _ref_convbn(p["block"], s["block"], f"{pfx}.block", out)
        elif spec.kind == "RepVGGBlock":
            _ref_repvgg(p, s, pfx, out, kw["cin"] == kw["cout"] and kw["stride"] == 1)
        elif spec.kind == "SPPF":
            for cv in ("cv1", "cv2"):
                _ref_convbn(p[cv], s[cv], f"{pfx}.{cv}", out)
        elif spec.kind == "MPRep":
            _ref_convbn(p["pool_proj"], s["pool_proj"], f"{pfx}.conv1", out)
            _ref_repvgg(p["rep_down"], s["rep_down"], f"{pfx}.conv2", out, False)
        elif spec.kind == "RepHDW":
            _ref_convbn(p["cv_in"], s["cv_in"], f"{pfx}.conv1", out)
            _ref_convbn(p["cv_out"], s["cv_out"], f"{pfx}.conv2", out)
            for i in range(kw["depth"]):
                mp, ms, mpfx = p[f"m{i}"], s[f"m{i}"], f"{pfx}.m.{i}"
                _ref_convbn(mp["expand"], ms["expand"], f"{mpfx}.conv1", out)
                _ref_unireplk(mp["dw"], ms["dw"], f"{mpfx}.conv2", out)
                _ref_convbn(mp["project"], ms["project"], f"{mpfx}.one_conv", out)
        elif spec.kind == "Head_DepthUni":
            _ref_convbn(p["stem"], s["stem"], f"{pfx}.stem", out)
            for role in ("cls", "reg"):
                _ref_unireplk(p[f"{role}_dw"], s[f"{role}_dw"], f"{pfx}.{role}_conv", out)
                _ref_convbn(p[f"{role}_proj"], s[f"{role}_proj"], f"{pfx}.{role}_conv_s", out)
                out[f"{pfx}.{role}_pred.weight"] = _ref_kernel(p[f"{role}_pred"]["kernel"])
                out[f"{pfx}.{role}_pred.bias"] = p[f"{role}_pred"]["bias"]
        else:
            raise NotImplementedError(spec.kind)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}
