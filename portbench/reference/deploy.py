"""Plain reference of a MAF-YOLO deploy graph: folded weights, the forward,
the DFL decode, greedy NMS, and fake quantization for the int8 cells and the
controls.

Plain torch operations only (F.conv2d, max_pool2d, interpolate), computed in
float32 with TF32 off; it imports nothing of the program. The deploy form
of every block is one biased convolution and its activation: RepVGG blocks
3x3 + ReLU, Conv rows k x k + SiLU, a RepHDW's bottleneck 1x1 SiLU, a
depthwise k x k conv without activation, SiLU, 1x1 SiLU; a head's 1x1 stem,
then per branch a depthwise conv, a 1x1 SiLU and the prediction conv. Leaf
names are those of the published checkpoint layout (the port's state_dict
without its `net.` prefix), so one set of tensors feeds both sides.

Quantization (`Quant`): symmetric, per-output-channel weights and per-tensor
activations whose amax the reference calibrates itself, as a max of |x| over
calibration batches with fake-quantized weights; the head's prediction convs
stay float; maxpool inputs and neck upsample outputs are quantized too.
int8 is the int8 cells' reference, int4 their control; float8 e4m3 the bf16
cells' control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.graph import parse

MAX_WH = 4096.0


def conv_leaves(layers):
    """[(leaf prefix, cout, cin per group, k, stride, groups, act)] of every
    deploy conv, in forward order; act None, "relu", "silu" or "pred"."""
    out = []
    for L in layers:
        p, a = f"layer{L.idx}", L.args
        if L.kind == "RepVGGBlock":
            out.append((f"{p}.fused.conv", L.cout, L.cin, 3, a["stride"], 1, "relu"))
        elif L.kind == "ConvWrapper":
            out.append((f"{p}.block.conv", L.cout, L.cin, a["k"], a["stride"], 1, "silu"))
        elif L.kind == "SPPF":
            c_ = L.cin // 2
            out += [(f"{p}.cv1.conv", c_, L.cin, 1, 1, 1, "silu"),
                    (f"{p}.cv2.conv", L.cout, 4 * c_, 1, 1, 1, "silu")]
        elif L.kind == "MPRep":
            c_ = L.cout // 2
            out += [(f"{p}.pool_proj.conv", c_, L.cin, 1, 1, 1, "silu"),
                    (f"{p}.rep_down.fused.conv", c_, L.cin, 3, 2, 1, "relu")]
        elif L.kind == "RepHDW":
            c_, mid, k = a["c_"], a["mid"], a["k"]
            out.append((f"{p}.cv_in.conv", 2 * c_, L.cin, 1, 1, 1, "silu"))
            for i in range(a["depth"]):
                out += [(f"{p}.m{i}.expand.conv", mid, c_, 1, 1, 1, "silu"),
                        (f"{p}.m{i}.dw.fused.conv", mid, 1, k, 1, mid, None),
                        (f"{p}.m{i}.project.conv", c_, mid, 1, 1, 1, "silu")]
            out.append((f"{p}.cv_out.conv", L.cout, (a["depth"] + 2) * c_, 1, 1, 1, "silu"))
        elif L.kind == "Head_DepthUni":
            c, k = L.cout, a["k"]
            out.append((f"{p}.stem.conv", c, L.cin, 1, 1, 1, "silu"))
            for br, n_out in (("cls", a["nc"]), ("reg", 4 * (a["reg_max"] + 1))):
                out += [(f"{p}.{br}_dw.fused.conv", c, 1, k, 1, c, None),
                        (f"{p}.{br}_proj.conv", c, c, 1, 1, 1, "silu"),
                        (f"{p}.{br}_pred", n_out, c, 1, 1, 1, "pred")]
    return out


def leaf_shapes(layers) -> Dict[str, tuple]:
    """name -> shape of every folded leaf (weight OIHW, bias)."""
    shapes = {}
    for name, cout, cin_g, k, _, _, _ in conv_leaves(layers):
        shapes[f"{name}.weight"] = (cout, cin_g, k, k)
        shapes[f"{name}.bias"] = (cout,)
    return shapes


def random_weights(layers, seed: int, device, gain: float = 1.5) -> Dict[str, torch.Tensor]:
    """Folded weights from `seed`, drawn on `device` in one call: a conv's
    weight U(+-gain * sqrt(3 / fan_in)) (unit variance kept at gain 1; 1.5
    keeps activations image-dependent through the 34 layers), a bias
    U(+-0.2)."""
    shapes = leaf_shapes(layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, o = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale = gain * math.sqrt(3.0 / math.prod(shape[1:])) if len(shape) == 4 else 0.2
        out[name] = (flat[o:o + n] * scale).reshape(shape)
        o += n
    return out


def fake_quant(x, amax, bits: int):
    """Symmetric fake quantization: scale = amax / qmax, round half to even,
    clip to [-qmax - 1, qmax]; amax may be per channel (broadcast)."""
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(amax, min=1e-12) / qmax
    return torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale


def fake_fp8(x, amax):
    """x rounded to float8 e4m3 under the scale that maps amax to its
    largest value, 448; amax may be per channel (broadcast)."""
    scale = torch.clamp(amax, min=1e-12) / 448.0
    return (x / scale).clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Quant:
    """Fake quantization of a deploy forward: `bits` 8 or 4 (integers), or
    "fp8" (float8 e4m3). In calib mode it records the running max |x| of
    each site; afterwards it quantizes."""

    def __init__(self, bits):
        self.bits, self.calib, self.amax = bits, True, {}

    def _round(self, x, amax):
        return fake_fp8(x, amax) if self.bits == "fp8" else fake_quant(x, amax, self.bits)

    def act(self, site: str, x):
        if self.calib:
            m = x.detach().abs().amax()
            self.amax[site] = torch.maximum(self.amax[site], m) if site in self.amax else m
            return x
        return self._round(x, self.amax[site])

    def weight(self, w):
        return self._round(w, w.abs().amax((1, 2, 3), keepdim=True))


def _act(y, act):
    if act == "relu":
        return F.relu(y)
    if act == "silu":
        return F.silu(y)
    return y


def forward(sd, layers, heads, x, quant: Optional[Quant] = None, convs: Optional[list] = None,
            taps: Optional[dict] = None):
    """x: float NCHW RGB in [0, 1] -> [(cls logits, reg logits)] NCHW a head
    level. sd maps leaf names to tensors; convs, if given, collects (x shape,
    weight shape, output shape, groups, act) of each conv; taps, if given,
    the input of each prediction conv by its leaf name."""
    leaves = {c[0]: c for c in conv_leaves(layers)}

    def conv(name, x):
        _, cout, cin_g, k, stride, groups, act = leaves[name]
        w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
        if quant is not None and act != "pred":
            w = quant.weight(w)
            x = quant.act(name, x)
        y = F.conv2d(x, w, b, stride, k // 2, groups=groups)
        if convs is not None:
            convs.append((tuple(x.shape), tuple(w.shape), tuple(y.shape), groups, act))
        return _act(y, act)

    def q(site, x):
        return x if quant is None else quant.act(site, x)

    ys = {-1: x}                  # layer 0 reads the image
    for L in layers:
        p, a = f"layer{L.idx}", L.args
        inp = [ys[j] for j in L.frm]
        h = inp[0]
        if L.kind == "RepVGGBlock":
            h = conv(f"{p}.fused.conv", h)
        elif L.kind == "ConvWrapper":
            h = conv(f"{p}.block.conv", h)
        elif L.kind == "SPPF":
            h = conv(f"{p}.cv1.conv", h)
            pools = [h]
            for _ in range(3):
                pools.append(F.max_pool2d(q(f"{p}.pool_q", pools[-1]), a["k"], 1, a["k"] // 2))
            h = conv(f"{p}.cv2.conv", torch.cat(pools, 1))
        elif L.kind == "MPRep":
            left = conv(f"{p}.pool_proj.conv", F.max_pool2d(q(f"{p}.pool_q", h), 2, 2))
            h = torch.cat([left, conv(f"{p}.rep_down.fused.conv", h)], 1)
        elif L.kind == "RepHDW":
            h = conv(f"{p}.cv_in.conv", h)
            parts = [h[:, :a["c_"]], h[:, a["c_"]:]]
            for i in range(a["depth"]):
                m = conv(f"{p}.m{i}.expand.conv", parts[-1])
                m = F.silu(conv(f"{p}.m{i}.dw.fused.conv", m))
                parts.append(conv(f"{p}.m{i}.project.conv", m))
            h = conv(f"{p}.cv_out.conv", torch.cat(parts, 1))
        elif L.kind == "Upsample":
            h = q(f"{p}.up_q", F.interpolate(h, scale_factor=2, mode="nearest"))
        elif L.kind == "Concat":
            h = torch.cat(inp, 1)
        elif L.kind == "Head_DepthUni":
            s = conv(f"{p}.stem.conv", h)
            branch = {}
            for br in ("cls", "reg"):
                t = conv(f"{p}.{br}_proj.conv", conv(f"{p}.{br}_dw.fused.conv", s))
                if taps is not None:
                    taps[f"{p}.{br}_pred"] = t
                branch[br] = conv(f"{p}.{br}_pred", t)
            h = (branch["cls"], branch["reg"])
        elif L.kind == "Out":
            return [ys[j] for j in heads]
        ys[L.idx] = h
    raise ValueError("graph has no Out row")


def to_input(imgs_u8):
    """uint8 BGR NHWC -> float32 RGB NCHW in [0, 1]."""
    return imgs_u8.flip(-1).permute(0, 3, 1, 2).float() / 255.0


def decode(levels, strides, reg_max: int):
    """-> (scores [B, A, nc] sigmoid, boxes [B, A, 4] xyxy px): anchors at
    cell centres, row-major a level; ltrb the softmax expectation of each
    side's reg_max + 1 bins, times the stride."""
    scores, boxes = [], []
    for (cls, reg), s in zip(levels, strides):
        b, nc, h, w = cls.shape
        scores.append(torch.sigmoid(cls.float()).permute(0, 2, 3, 1).reshape(b, h * w, nc))
        r = reg.float().permute(0, 2, 3, 1).reshape(b, h * w, 4, reg_max + 1)
        ltrb = torch.softmax(r, -1) @ torch.arange(reg_max + 1, dtype=torch.float32,
                                                   device=r.device)
        gy, gx = torch.meshgrid(torch.arange(h, device=r.device, dtype=torch.float32),
                                torch.arange(w, device=r.device, dtype=torch.float32),
                                indexing="ij")
        pts = torch.stack([gx, gy], -1).reshape(1, h * w, 2) + 0.5
        boxes.append(torch.cat([(pts - ltrb[..., :2]) * s, (pts + ltrb[..., 2:]) * s], -1))
    return torch.cat(scores, 1), torch.cat(boxes, 1)


def _iou(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda t: (t[:, 2:] - t[:, :2]).clamp(min=0).prod(-1)   # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-9)


def nms(scores, boxes, conf: float, iou_thres: float, max_det: int) -> List[dict]:
    """Multi-label greedy NMS of one batch, image by image: every (anchor,
    class) pair above conf, score-descending (ties by anchor, then class),
    suppressed by an earlier kept pair of its class with IoU > iou_thres,
    at most max_det kept. -> [{"boxes", "scores", "classes"}] on the host."""
    out = []
    for sc, bx in zip(scores.cpu(), boxes.cpu()):
        a, c = torch.nonzero(sc > conf, as_tuple=True)
        s = sc[a, c]
        order = torch.sort(-s, stable=True).indices
        a, c, s = a[order], c[order], s[order]
        off = bx[a].double() + c[:, None].double() * MAX_WH
        removed = torch.zeros(len(s), dtype=torch.bool)
        keep, i = [], 0
        while i < len(s):
            keep.append(i)
            if len(keep) == max_det:
                break
            # the kept pair's row of IoUs alone: K rows, not an N x N matrix
            removed[i + 1:] |= _iou(off[i:i + 1], off[i + 1:])[0] > iou_thres
            rest = torch.nonzero(~removed[i + 1:])
            if len(rest) == 0:
                break
            i += 1 + int(rest[0])
        k = torch.tensor(keep, dtype=torch.long)
        out.append({"boxes": bx[a[k]], "scores": s[k], "classes": c[k]})
    return out


class Model:
    """A configuration's deploy graph with its weights: the f32 forward,
    optionally under a Quant."""

    def __init__(self, config, weights):
        self.layers, self.heads = parse(config["graph"], config["nc"])
        self.sd, self.config = weights, config

    def levels(self, imgs_u8, quant=None, block: int = 8):
        """Head logits of uint8 images, `block` images at a time."""
        outs = [forward(self.sd, self.layers, self.heads, to_input(imgs_u8[i:i + block]), quant)
                for i in range(0, imgs_u8.shape[0], block)]
        return [tuple(torch.cat([o[lv][j] for o in outs]) for j in range(2))
                for lv in range(len(self.heads))]

    def decoded(self, imgs_u8, quant=None):
        c = self.config
        return decode(self.levels(imgs_u8, quant), c["strides"], c["reg_max"])

    def calibrate(self, bits, batches) -> Quant:
        """A Quant at `bits` (8, 4 or "fp8"), its amax the max |x| of each
        site over `batches` of uint8 images."""
        quant = Quant(bits)
        for imgs in batches:
            self.levels(imgs, quant)
        quant.calib = False
        return quant


def condition_heads(model: Model, calib_imgs, pairs_per_image: float, live: int = 2):
    """Random heads made to give detections, in place, from the features
    that calib_imgs give the prediction convs. Each row of a prediction
    conv is first kept to the span of the features' principal directions
    (a component outside it carries rounding noise and no signal) and loses
    its response to the mean feature (a random row's response to the mostly
    positive SiLU features is a large constant, which a conv in any
    precision would carry and the bias cancel). Then each
    level keeps `live` classes (l * live ...), scaled alike so that about
    pairs_per_image (anchor, class) pairs of an image clear conf 0.03; the
    other classes get a zero row and bias -30 and never fire (with two live
    classes an anchor never has more than two above the threshold). Each
    regression row is scaled to a unit spread of its logits over the
    calibration anchors, so that the DFL bins are neither flat nor one-hot."""
    sd, n = model.sd, calib_imgs.shape[0]
    taps: dict = {}
    forward(sd, model.layers, model.heads, to_input(calib_imgs), taps=taps)

    def centred(name):
        """The conv's rows kept to the span of the features' principal
        directions (99.9% of their variance) and without response to the
        mean feature; and their responses over the calibration anchors."""
        f = taps[name].double().permute(0, 2, 3, 1).reshape(-1, taps[name].shape[1])
        mean = f.mean(0)
        # on the host: a C x C matrix, and no solver library to load on the card
        lam, vec = (t.to(f.device) for t in torch.linalg.eigh(torch.cov(f.T).cpu()))
        keep = vec[:, lam.flip(0).cumsum(0).flip(0) > 1e-3 * lam.sum()]
        w = sd[f"{name}.weight"].double()[:, :, 0, 0] @ keep @ keep.T
        g = keep @ (keep.T @ mean)
        w = w - (w @ mean)[:, None] * g[None, :] / g.dot(mean)
        return w, f @ w.T                       # [rows, C], responses [anchors, rows]
    scores = []
    for lvl, layer in enumerate(model.heads):
        w, z = centred(f"layer{layer}.reg_pred")
        sd[f"layer{layer}.reg_pred.weight"] = (w / z.std(0)[:, None]).float()[..., None, None]
        cls_ids = list(range(live * lvl, live * lvl + live))
        w, z = centred(f"layer{layer}.cls_pred")
        scores.append((layer, cls_ids, w[cls_ids], z[:, cls_ids]))
    z_all = torch.cat([z.flatten() for *_, z in scores])
    a = 2.5 / z_all.std().item()
    q = (a * z_all).sort(descending=True).values
    c = math.log(0.03 / 0.97) - q[min(int(pairs_per_image * n), q.numel() - 1)].item()
    for layer, cls_ids, w, _ in scores:
        old_w = sd[f"layer{layer}.cls_pred.weight"]
        new_w, new_b = torch.zeros_like(old_w), torch.full((old_w.shape[0],), -30.0,
                                                          device=old_w.device)
        new_w[cls_ids] = (a * w).float()[..., None, None]
        new_b[cls_ids] = c
        sd[f"layer{layer}.cls_pred.weight"], sd[f"layer{layer}.cls_pred.bias"] = new_w, new_b


def shapes_of_convs(config, batch: int, img: int):
    """[(x shape, weight shape, output shape, groups, act)] of every conv of
    the deploy forward of a batch, from shapes alone (the meta device)."""
    layers, heads = parse(config["graph"], config["nc"])
    sd = {k: torch.empty(s, device="meta") for k, s in leaf_shapes(layers).items()}
    convs: list = []
    forward(sd, layers, heads, torch.empty(batch, 3, img, img, device="meta"), convs=convs)
    return convs


def count_macs(config, img: int) -> int:
    """Multiply-adds of the deploy forward of one img x img image."""
    return sum(math.prod(y) * w[1] * w[2] * w[3]
               for _, w, y, _, _ in shapes_of_convs(config, 1, img))
