"""Plain reference of an Ultralytics YOLO11 deploy graph, for the cells of a
configuration that names `"reference": "yolo11"`: the parse with
Ultralytics' scale rule, folded weights, the forward, and what the serve
driver and the check need of it (Model, random_weights, condition_heads),
with the operations and bytes the yardstick counts.

A copy of reference/yolo11.py at the repository's root, folded form only,
with the hooks of reference/deploy.py: fake quantization (its Quant, at
every conv's input and weights, the max-pool inputs, the upsample outputs
and the attention's q, k and v), the prediction convs' inputs tapped, and
each conv's shapes collected. Plain torch, float32 with TF32 off (the
caller's compare.plain_f32); it imports nothing of the program. The DFL
decode, greedy NMS and fake quantization are reference/deploy.py's. Leaf
names are the program's state_dict's without `net.`: a conv site `<p>` is
`<p>.conv.weight` and `<p>.conv.bias`, a prediction conv `<p>.weight` and
`<p>.bias`; a Conv row's site is `layer<i>.block`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import deploy as D
from portbench.reference.deploy import Quant, to_input


def make_divisible(x: float, divisor: int) -> int:
    return int(math.ceil(x / divisor) * divisor)


@dataclasses.dataclass(frozen=True)
class Layer:
    idx: int
    frm: Tuple[int, ...]
    kind: str
    args: Dict
    cin: int
    cout: int


def parse(graph: dict, nc: int):
    """-> (layers, head indices): one Layer a row, the Out row's sources.
    Widths make_divisible(min(c, max_channels) * width, 8), repeats
    max(round(n * depth), 1) where n > 1, C3k blocks in every C3k2 at scales
    m, l and x; Detect's c2 and c3 from its first level's width."""
    gd, gw, mc = graph["depth_multiple"], graph["width_multiple"], graph["max_channels"]
    forced = graph.get("scale") in ("m", "l", "x")
    rows = list(graph["backbone"]) + list(graph["neck"]) + list(graph["effidehead"])
    ch, layers, heads, c_first = [], [], (), None
    for i, (f, n, kind, args) in enumerate(rows):
        frm = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        src = [i + j if j < 0 else j for j in frm]
        cin = 3 if i == 0 else ch[src[0]]
        n = max(round(n * gd), 1) if n > 1 else n
        a: Dict = {}
        if kind in ("Conv", "SPPF", "C3k2", "C2PSA"):
            cout = make_divisible(min(args[0], mc) * gw, 8)
            if kind == "Conv":
                a = dict(k=args[1], s=args[2])
            elif kind == "SPPF":
                a = dict(k=args[1])
            elif kind == "C3k2":
                a = dict(n=n, c3k=(len(args) > 1 and bool(args[1])) or forced,
                         c=int(cout * (args[2] if len(args) > 2 else 0.5)))
            else:
                # C2PSA's c = cin / 2, PSABlocks of c // 64 heads of c / heads
                # channels, q and k at half that (attn_ratio 0.5)
                c = cin // 2
                heads = c // 64
                a = dict(n=n, c=c, heads=heads, kd=c // heads // 2, hd=c // heads)
        elif kind == "nn.Upsample":
            cout = cin
        elif kind == "Concat":
            cout = sum(ch[j] for j in src)
        elif kind == "Head_Detect":
            c_first = cin if c_first is None else c_first
            reg_max = int(args[0])
            cout = cin
            a = dict(reg_max=reg_max, c2=max(16, c_first // 4, 4 * (reg_max + 1)),
                     c3=max(c_first, min(nc, 100)), nc=nc)
        elif kind == "Out":
            heads = tuple(src)
            cout = ch[-1]
        else:
            raise NotImplementedError(f"row kind {kind!r} is not in the YOLO11 graph")
        layers.append(Layer(i, tuple(src), kind, a, cin, cout))
        ch.append(cout)
    return layers, heads


def _layer_shapes(L):
    """(name, shape) of each folded leaf of a layer."""
    p, a = f"layer{L.idx}", L.args

    def site(q, cout, cin_g, k):
        return [(f"{q}.conv.weight", (cout, cin_g, k, k)), (f"{q}.conv.bias", (cout,))]

    def bottleneck(q, c_in, c_mid):
        return site(f"{q}.cv1", c_mid, c_in, 3) + site(f"{q}.cv2", c_in, c_mid, 3)
    out = []
    if L.kind == "Conv":
        out = site(f"{p}.block", L.cout, L.cin, a["k"])
    elif L.kind == "C3k2":
        c = a["c"]
        out = site(f"{p}.cv1", 2 * c, L.cin, 1) + site(f"{p}.cv2", L.cout, (2 + a["n"]) * c, 1)
        for j in range(a["n"]):
            q = f"{p}.m.{j}"
            if a["c3k"]:
                c_ = c // 2
                out += site(f"{q}.cv1", c_, c, 1) + site(f"{q}.cv2", c_, c, 1) \
                    + site(f"{q}.cv3", c, 2 * c_, 1)
                out += bottleneck(f"{q}.m.0", c_, c_) + bottleneck(f"{q}.m.1", c_, c_)
            else:
                out += bottleneck(q, c, c // 2)
    elif L.kind == "SPPF":
        c_ = L.cin // 2
        out = site(f"{p}.cv1", c_, L.cin, 1) + site(f"{p}.cv2", L.cout, 4 * c_, 1)
    elif L.kind == "C2PSA":
        c = a["c"]
        out = site(f"{p}.cv1", 2 * c, L.cin, 1) + site(f"{p}.cv2", L.cin, 2 * c, 1)
        for j in range(a["n"]):
            q = f"{p}.m.{j}"
            out += site(f"{q}.attn.qkv", c + 2 * a["kd"] * a["heads"], c, 1) \
                + site(f"{q}.attn.proj", c, c, 1) + site(f"{q}.attn.pe", c, 1, 3) \
                + site(f"{q}.ffn.0", 2 * c, c, 1) + site(f"{q}.ffn.1", c, 2 * c, 1)
    elif L.kind == "Head_Detect":
        c2, c3, c1, nreg = a["c2"], a["c3"], L.cin, 4 * (a["reg_max"] + 1)
        out = site(f"{p}.reg0", c2, c1, 3) + site(f"{p}.reg1", c2, c2, 3) \
            + site(f"{p}.cls_dw0", c1, 1, 3) + site(f"{p}.cls_pw0", c3, c1, 1) \
            + site(f"{p}.cls_dw1", c3, 1, 3) + site(f"{p}.cls_pw1", c3, c3, 1)
        out += [(f"{p}.reg_pred.weight", (nreg, c2, 1, 1)), (f"{p}.reg_pred.bias", (nreg,)),
                (f"{p}.cls_pred.weight", (a["nc"], c3, 1, 1)),
                (f"{p}.cls_pred.bias", (a["nc"],))]
    return out


def leaf_shapes(layers) -> Dict[str, tuple]:
    """name -> shape of every folded leaf."""
    return {name: shape for L in layers for name, shape in _layer_shapes(L)}


def random_weights(layers, seed: int, device, gain: float = 1.5,
                   bias: float = 0.02) -> Dict[str, torch.Tensor]:
    """Folded weights from `seed`, drawn on `device` in one call: a conv's
    weight U(+-gain * sqrt(3 / fan_in)), a bias U(+-bias), as
    reference/deploy.py:random_weights draws them. The biases are ten times
    smaller than N's: with U(+-0.2) YOLO11x's residual stacks leave the head
    features a constant with some 1% of image-dependent spread on random
    images, with U(+-0.02) 13-53% (at gain 1.5; seeds 1-3 and 4000000001,
    four 320 px images)."""
    shapes = leaf_shapes(layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, o = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale = gain * math.sqrt(3.0 / math.prod(shape[1:])) if len(shape) == 4 else bias
        out[name] = (flat[o:o + n] * scale).reshape(shape)
        o += n
    return out


def forward(sd, layers, heads, x, quant: Optional[Quant] = None, convs: Optional[list] = None,
            taps: Optional[dict] = None):
    """x: float NCHW RGB in [0, 1] -> [(cls logits, reg logits)] NCHW a head
    level (reference/yolo11.py's folded forward). quant, convs and taps as
    reference/deploy.py:forward's; convs' entries are (x shape, weight
    shape, output shape, groups, act) with act "silu", None or "pred"."""

    def run_conv(name, x, w, b, k, s, g, act):
        if quant is not None and act != "pred":
            w = quant.weight(w)
            x = quant.act(name, x)
        y = F.conv2d(x, w, b, s, k // 2, groups=g)
        if convs is not None:
            convs.append((tuple(x.shape), tuple(w.shape), tuple(y.shape), g, act))
        return F.silu(y) if act == "silu" else y

    def conv(p, x, k=1, s=1, g=1, act="silu"):
        return run_conv(p, x, sd[f"{p}.conv.weight"], sd[f"{p}.conv.bias"], k, s, g, act)

    def pred(p, x):
        if taps is not None:
            taps[p] = x
        return run_conv(p, x, sd[f"{p}.weight"], sd[f"{p}.bias"], 1, 1, 1, "pred")

    def q(site, x):
        return x if quant is None else quant.act(site, x)

    def bottleneck(p, x):
        return x + conv(f"{p}.cv2", conv(f"{p}.cv1", x, 3), 3)

    def c3k(p, x):
        y = conv(f"{p}.cv1", x)
        for j in range(2):
            y = bottleneck(f"{p}.m.{j}", y)
        return conv(f"{p}.cv3", torch.cat([y, conv(f"{p}.cv2", x)], 1))

    def attention(p, x, a):
        b, c, h, w = x.shape
        n, kd, hd = h * w, a["kd"], a["hd"]
        qkv = conv(f"{p}.qkv", x, act=None)
        qq, kk, v = qkv.view(b, a["heads"], 2 * kd + hd, n).split([kd, kd, hd], dim=2)
        qq, kk, vq = q(f"{p}.q", qq), q(f"{p}.k", kk), q(f"{p}.v", v)
        attn = ((qq.transpose(-2, -1) @ kk) * kd ** -0.5).softmax(dim=-1)
        y = (vq @ attn.transpose(-2, -1)).reshape(b, c, h, w) \
            + conv(f"{p}.pe", v.reshape(b, c, h, w), 3, g=c, act=None)
        return conv(f"{p}.proj", y, act=None)

    ys = {}
    for L in layers:
        p, a = f"layer{L.idx}", L.args
        inp = [x if L.idx == 0 else ys[j] for j in L.frm]
        h = inp[0]
        if L.kind == "Conv":
            h = conv(f"{p}.block", h, a["k"], a["s"])
        elif L.kind == "C3k2":
            y = conv(f"{p}.cv1", h)
            parts = [y[:, :a["c"]], y[:, a["c"]:]]
            for j in range(a["n"]):
                parts.append((c3k if a["c3k"] else bottleneck)(f"{p}.m.{j}", parts[-1]))
            h = conv(f"{p}.cv2", torch.cat(parts, 1))
        elif L.kind == "SPPF":
            h = conv(f"{p}.cv1", h)
            pools = [h]
            for _ in range(3):
                pools.append(F.max_pool2d(q(f"{p}.pool_q", pools[-1]), a["k"], 1, a["k"] // 2))
            h = conv(f"{p}.cv2", torch.cat(pools, 1))
        elif L.kind == "C2PSA":
            y = conv(f"{p}.cv1", h)
            t = y[:, a["c"]:]
            for j in range(a["n"]):
                t = t + attention(f"{p}.m.{j}.attn", t, a)
                t = t + conv(f"{p}.m.{j}.ffn.1", conv(f"{p}.m.{j}.ffn.0", t), act=None)
            h = conv(f"{p}.cv2", torch.cat([y[:, :a["c"]], t], 1))
        elif L.kind == "nn.Upsample":
            h = q(f"{p}.up_q", F.interpolate(h, scale_factor=2, mode="nearest"))
        elif L.kind == "Concat":
            h = torch.cat(inp, 1)
        elif L.kind == "Head_Detect":
            reg = pred(f"{p}.reg_pred", conv(f"{p}.reg1", conv(f"{p}.reg0", h, 3), 3))
            t = conv(f"{p}.cls_pw0", conv(f"{p}.cls_dw0", h, 3, g=L.cin))
            t = conv(f"{p}.cls_pw1", conv(f"{p}.cls_dw1", t, 3, g=a["c3"]))
            h = (pred(f"{p}.cls_pred", t), reg)
        elif L.kind == "Out":
            return [ys[j] for j in heads]
        ys[L.idx] = h
    raise ValueError("graph has no Out row")


class Model(D.Model):
    """A configuration's deploy graph with its weights: the f32 forward,
    optionally under a Quant; decoded and calibrate are
    reference/deploy.py:Model's, over this graph's forward."""

    def __init__(self, config, weights):
        self.layers, self.heads = parse(config["graph"], config["nc"])
        self.sd, self.config = weights, config

    def levels(self, imgs_u8, quant=None, block: int = 8):
        """Head logits of uint8 images, `block` images at a time."""
        outs = [forward(self.sd, self.layers, self.heads, to_input(imgs_u8[i:i + block]), quant)
                for i in range(0, imgs_u8.shape[0], block)]
        return [tuple(torch.cat([o[lv][j] for o in outs]) for j in range(2))
                for lv in range(len(self.heads))]


def condition_heads(model: Model, calib_imgs, pairs_per_image: float, conf_thres: float,
                    live: int = 2):
    """reference/deploy.py:condition_heads for a YOLO11 graph, at the cell's
    conf_thres: each prediction row kept to the span of its features'
    principal directions (99.9% of their variance) and without response to
    the mean feature; each level keeps `live` classes (l * live ...),
    scaled alike so that about pairs_per_image (anchor, class) pairs of an
    image clear conf_thres, the other classes a zero row and bias -30; each
    regression row scaled to a unit spread of its logits over the
    calibration anchors."""
    sd, n = model.sd, calib_imgs.shape[0]
    taps: dict = {}
    forward(sd, model.layers, model.heads, to_input(calib_imgs), taps=taps)

    def centred(name):
        f = taps[name].double().permute(0, 2, 3, 1).reshape(-1, taps[name].shape[1])
        mean = f.mean(0)
        lam, vec = (t.to(f.device) for t in torch.linalg.eigh(torch.cov(f.T).cpu()))
        keep = vec[:, lam.flip(0).cumsum(0).flip(0) > 1e-3 * lam.sum()]
        w = sd[f"{name}.weight"].double()[:, :, 0, 0] @ keep @ keep.T
        g = keep @ (keep.T @ mean)
        w = w - (w @ mean)[:, None] * g[None, :] / g.dot(mean)
        return w, f @ w.T
    scores = []
    for lvl, layer in enumerate(model.heads):
        w, z = centred(f"layer{layer}.reg_pred")
        sd[f"layer{layer}.reg_pred.weight"] = (w / z.std(0)[:, None]).float()[..., None, None]
        cls_ids = list(range(live * lvl, live * lvl + live))
        w, z = centred(f"layer{layer}.cls_pred")
        scores.append((layer, cls_ids, w[cls_ids], z[:, cls_ids]))
    z_all = torch.cat([z.flatten() for *_, z in scores])
    a = 2.5 / z_all.std().item()
    srt = (a * z_all).sort(descending=True).values
    c = math.log(conf_thres / (1 - conf_thres)) \
        - srt[min(int(pairs_per_image * n), srt.numel() - 1)].item()
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
    """Multiply-adds of the deploy forward's convolutions on one img x img
    image (the attention's matrix products left out, as Ultralytics counts)."""
    return sum(math.prod(y) * w[1] * w[2] * w[3]
               for _, w, y, _, _ in shapes_of_convs(config, 1, img))


def attention_counts(config, batch: int, img: int):
    """(bytes, operations) of the PSA attentions of a batch: q, k and v
    read once and the output written once, in bf16; 2 (dk + dv) N^2
    operations a head (q k^T and the product with v), N the cells of the
    map they attend over."""
    layers, _ = parse(config["graph"], config["nc"])
    nbytes = ops = 0
    for L in layers:
        if L.kind != "C2PSA":
            continue
        a, n = L.args, (img // 32) ** 2
        per = a["heads"] * n * (2 * a["kd"] + 2 * a["hd"]) * 2     # q, k, v, out
        nbytes += a["n"] * batch * per
        ops += a["n"] * batch * a["heads"] * 2 * n * n * (a["kd"] + a["hd"])
    return nbytes, ops


def dw_sites(config, batch: int, img: int, k: int = 3):
    """[(x shape, weight shape, output shape)] of the deploy graph's
    depthwise convs of kernel size k."""
    return [(x, w, y) for x, w, y, g, _ in shapes_of_convs(config, batch, img)
            if g > 1 and w[2] == k]
