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

from pathlib import Path

import numpy as np
import torch

from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.data.datasets import DetectionDataset
from mafyolo_tpu_torch.models.blocks import DWConv
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
    """An Evaler of `name` on the folded tree, NC classes."""
    ev = Evaler(half=half, device=device)
    ev.init_model(name, folded, nc=NC, folded=True)
    return ev


def random_deploy(name, dev):
    """Random folded weights (seed 0, gain 1.5) whose heads give detections.

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
    specs, _, head_layers = parse_graph(MODEL_ZOO[name], nc=NC)
    folded = random_folded_variables(specs, seed=0, weight_gain=1.5)
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


def int8_silu_every_bf16(dev):
    """The int8 conv's fused SiLU epilogue on every finite bf16 value (a 1x1
    conv whose scale is 0 and whose bias holds the values) against torch's
    bf16 SiLU: (values, how many differ)."""
    import dataclasses

    from mafyolo_tpu_torch.ops import quant_conv as QC
    vals = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    vals = vals.float()[torch.isfinite(vals.float())]
    w = torch.randn((vals.numel(), 16, 1, 1), generator=torch.Generator().manual_seed(13))
    p = QC.pack(w, torch.zeros(vals.numel()), torch.tensor(1.0), 1, 0, 1).to(dev)
    p = dataclasses.replace(p, scale=torch.zeros_like(p.scale), bias=vals.to(dev))
    x = torch.ones((1, 16, 1, 1), device=dev, dtype=torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    got = QC.int8_conv(x, p, "silu").flatten()
    want = torch.nn.functional.silu(vals.to(dev, torch.bfloat16))
    return vals.numel(), int((got != want).sum())


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


def reference_state_dict(variables, specs):
    """A train-form {'params','batch_stats'} tree (numpy, HWIO) -> the
    reference's state_dict of the same weights ('backbone.{i}.' keys, OIHW,
    torch tensors): the inverse of utils/torch_bridge.py:convert_layer for
    the yaml graphs' kinds, with the reference's key quirks (rbr_identity
    only where cin == cout at stride 1, dil_conv_k{k}_{r} / dil_bn_k{k}_{r},
    cls_conv_s / reg_conv_s, MPRep's conv1 / conv2)."""
    params, stats = variables["params"]["net"], variables["batch_stats"]["net"]
    out = {}
    for spec in specs:
        name, kw, pfx = f"layer{spec.idx}", spec.kw, f"backbone.{spec.idx}"
        if name not in params:
            continue
        p, s = params[name], stats.get(name, {})
        if spec.kind == "ConvWrapper":
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
