"""Plain reference of Ultralytics YOLO11 (ultralytics/cfg/models/11/yolo11.yaml,
the modules of ultralytics/nn/modules/{conv,block,head}.py): the graph's
parse with Ultralytics' scale rule, the forward in train form (conv + BN in
eval, BN eps 1e-3 as Ultralytics' initialize_weights sets it) and in folded
form (biased convs), the fold, the DFL decode and multi-label greedy NMS.

Plain torch operations only (F.conv2d, F.batch_norm, max_pool2d,
interpolate, matmul, softmax), float32 with TF32 off while it runs (`run`);
no kernels, no cache, no batching. It imports neither JAX nor the port.

The graph is a dict: the yaml's backbone and head rows under `backbone` and
`neck`, its Detect row written as one `Head_Detect` row a level (args
[reg_max], 15 for 16 DFL bins) and an `Out` row under `effidehead`, and the
scale as `depth_multiple`, `width_multiple`, `max_channels` and `scale`
(its letter). Widths are make_divisible(min(c, max_channels) * width, 8),
repeats max(round(n * depth), 1) where n > 1, and at scales m, l and x every
C3k2 row takes C3k blocks, as Ultralytics' parse_model does.

Leaf names (a state_dict without a `net.` prefix): a conv site `<p>` holds
`<p>.conv.weight` and `<p>.bn.{weight,bias,running_mean,running_var}` in
train form, `<p>.conv.weight` and `<p>.conv.bias` folded; a prediction conv
`<p>.weight` and `<p>.bias`. Ultralytics' `model.<i>.<rest>` is
`layer<i>.<rest>` with these differences: a Conv row's site is
`layer<i>.block` (Ultralytics `model.<i>`); Detect's level l is the row
`layer<23 + l>` with reg0, reg1, reg_pred for `cv2.<l>.{0,1,2}` and cls_dw0,
cls_pw0, cls_dw1, cls_pw1, cls_pred for `cv3.<l>.{0.0,0.1,1.0,1.1,2}`.

Departures from Ultralytics, none in the mathematics of the model:
  - the image is taken as already 640 x 640 (or any multiple of 32): no
    letterbox, no rescale of the boxes;
  - NMS is a plain greedy loop over every (anchor, class) pair above conf,
    score-descending (ties by anchor, then class), each class's boxes
    offset by 4096 px, a pair dropped when it overlaps a kept one by IoU >
    iou_thres, at most max_det kept: Ultralytics' non_max_suppression with
    multi_label, which runs torchvision's NMS on the same offsets over at
    most max_nms (30000) pairs; the two differ only at equal scores;
  - boxes are decoded to xyxy directly (Ultralytics decodes to xywh and
    converts), the same values up to rounding.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
MAX_WH = 4096.0


def make_divisible(x: float, divisor: int) -> int:
    return int(math.ceil(x / divisor) * divisor)


@dataclasses.dataclass(frozen=True)
class Layer:
    idx: int
    frm: Tuple[int, ...]        # absolute source indices
    kind: str
    args: Dict
    cin: int
    cout: int


def parse(graph: dict, nc: int):
    """-> (layers, head indices): one Layer a row, the Out row's sources."""
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


def forward(sd, layers, heads, x, form: str = "folded", convs: Optional[list] = None):
    """x: float NCHW RGB in [0, 1] -> [(cls logits, reg logits)] NCHW a head
    level. form "train" (conv + BN in eval) or "folded"; convs, if given,
    collects (x shape, weight shape, output shape, groups) of each conv."""

    def conv(p, x, k=1, s=1, g=1, act=True):
        w = sd[f"{p}.conv.weight"]
        y = F.conv2d(x, w, None if form == "train" else sd[f"{p}.conv.bias"], s, k // 2,
                     groups=g)
        if form == "train":
            y = F.batch_norm(y, sd[f"{p}.bn.running_mean"], sd[f"{p}.bn.running_var"],
                             sd[f"{p}.bn.weight"], sd[f"{p}.bn.bias"], False, 0.0, BN_EPS)
        if convs is not None:
            convs.append((tuple(x.shape), tuple(w.shape), tuple(y.shape), g))
        return F.silu(y) if act else y

    def pred(p, x):
        w = sd[f"{p}.weight"]
        y = F.conv2d(x, w, sd[f"{p}.bias"])
        if convs is not None:
            convs.append((tuple(x.shape), tuple(w.shape), tuple(y.shape), 1))
        return y

    def bottleneck(p, x):          # e 1.0 in a C3k, 0.5 in a C3k2: the weights say
        return x + conv(f"{p}.cv2", conv(f"{p}.cv1", x, 3), 3)

    def c3k(p, x):
        y = conv(f"{p}.cv1", x)
        for j in range(2):
            y = bottleneck(f"{p}.m.{j}", y)
        return conv(f"{p}.cv3", torch.cat([y, conv(f"{p}.cv2", x)], 1))

    def attention(p, x, a):
        b, c, h, w = x.shape
        n, kd, hd = h * w, a["kd"], a["hd"]
        qkv = conv(f"{p}.qkv", x, act=False)
        q, k, v = qkv.view(b, a["heads"], 2 * kd + hd, n).split([kd, kd, hd], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * kd ** -0.5).softmax(dim=-1)
        y = (v @ attn.transpose(-2, -1)).view(b, c, h, w) \
            + conv(f"{p}.pe", v.reshape(b, c, h, w), 3, g=c, act=False)
        return conv(f"{p}.proj", y, act=False)

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
                block = c3k if a["c3k"] else bottleneck
                parts.append(block(f"{p}.m.{j}", parts[-1]))
            h = conv(f"{p}.cv2", torch.cat(parts, 1))
        elif L.kind == "SPPF":
            h = conv(f"{p}.cv1", h)
            pools = [h]
            for _ in range(3):
                pools.append(F.max_pool2d(pools[-1], a["k"], 1, a["k"] // 2))
            h = conv(f"{p}.cv2", torch.cat(pools, 1))
        elif L.kind == "C2PSA":
            y = conv(f"{p}.cv1", h)
            t = y[:, a["c"]:]
            for j in range(a["n"]):
                t = t + attention(f"{p}.m.{j}.attn", t, a)
                t = t + conv(f"{p}.m.{j}.ffn.1", conv(f"{p}.m.{j}.ffn.0", t), act=False)
            h = conv(f"{p}.cv2", torch.cat([y[:, :a["c"]], t], 1))
        elif L.kind == "nn.Upsample":
            h = F.interpolate(h, scale_factor=2, mode="nearest")
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


def fold(sd_train) -> Dict[str, torch.Tensor]:
    """Train-form leaves -> folded leaves: each conv + BN site's weight
    w * g / sqrt(var + eps) and bias beta - mean * g / sqrt(var + eps); the
    prediction convs as they are."""
    out = {}
    for name, t in sd_train.items():
        if name.endswith(".bn.weight"):
            p = name[:-len(".bn.weight")]
            scale = t / torch.sqrt(sd_train[f"{p}.bn.running_var"] + BN_EPS)
            out[f"{p}.conv.weight"] = sd_train[f"{p}.conv.weight"] * scale[:, None, None, None]
            out[f"{p}.conv.bias"] = sd_train[f"{p}.bn.bias"] \
                - sd_train[f"{p}.bn.running_mean"] * scale
        elif ".bn." not in name and not name.endswith(".conv.weight"):
            out[name] = t
    return out


def to_input(imgs_u8):
    """uint8 BGR NHWC -> float32 RGB NCHW in [0, 1]."""
    return imgs_u8.flip(-1).permute(0, 3, 1, 2).float() / 255.0


def decode(levels, strides, reg_max: int):
    """-> (scores [B, A, nc] sigmoid, boxes [B, A, 4] xyxy px): anchors at
    cell centres (+0.5), row-major a level; each side the softmax
    expectation of its reg_max + 1 bins, times the stride."""
    scores, boxes = [], []
    for (cls, reg), s in zip(levels, strides):
        b, nc, h, w = cls.shape
        scores.append(torch.sigmoid(cls.float()).permute(0, 2, 3, 1).reshape(b, h * w, nc))
        r = reg.float().permute(0, 2, 3, 1).reshape(b, h * w, 4, reg_max + 1)
        ltrb = torch.softmax(r, -1) @ torch.arange(reg_max + 1, dtype=torch.float32,
                                                   device=r.device)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=r.device),
                                torch.arange(w, dtype=torch.float32, device=r.device),
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
    """Multi-label greedy NMS, image by image (see the module docstring) ->
    [{"boxes", "scores", "classes"}] on the host."""
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
            removed[i + 1:] |= _iou(off[i:i + 1], off[i + 1:])[0] > iou_thres
            rest = torch.nonzero(~removed[i + 1:])
            if len(rest) == 0:
                break
            i += 1 + int(rest[0])
        k = torch.tensor(keep, dtype=torch.long)
        out.append({"boxes": bx[a[k]], "scores": s[k], "classes": c[k]})
    return out


@contextlib.contextmanager
def run():
    """float32 convolutions and matmuls without TF32, no gradient."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def predict(sd, graph, nc, imgs_u8, strides=(8, 16, 32), conf: float = 0.001,
            iou_thres: float = 0.7, max_det: int = 300, form: str = "folded"):
    """uint8 BGR NHWC images -> the NMS'd detections of each image, and the
    decoded (scores, boxes) they came from."""
    layers, heads = parse(graph, nc)
    with run():
        levels = forward(sd, layers, heads, to_input(imgs_u8).float(), form)
        scores, boxes = decode(levels, strides, layers[heads[0]].args["reg_max"])
        return nms(scores, boxes, conf, iou_thres, max_det), (scores, boxes)


def count_macs(graph, nc: int, img: int) -> int:
    """Multiply-adds of the folded forward's convolutions on one img x img
    image (the attention's matrix products left out, as Ultralytics counts),
    from shapes alone (the meta device)."""
    layers, heads = parse(graph, nc)
    sd = _meta_leaves(layers)
    convs: list = []
    forward(sd, layers, heads, torch.empty(1, 3, img, img, device="meta"), convs=convs)
    return sum(math.prod(y) * w[1] * w[2] * w[3] for _, w, y, _ in convs)


def _meta_leaves(layers):
    """Folded leaves of the right shapes on the meta device."""
    return {name: torch.empty(shape, device="meta")
            for L in layers for name, shape in _layer_shapes(L)}


def _layer_shapes(L):
    """(name, shape) of each folded leaf of a layer."""
    p, a = f"layer{L.idx}", L.args

    def site(q, cout, cin_g, k):
        return [(f"{q}.conv.weight", (cout, cin_g, k, k)), (f"{q}.conv.bias", (cout,))]

    def bottleneck(q, c):
        return site(f"{q}.cv1", c, c, 3) + site(f"{q}.cv2", c, c, 3)
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
                out += bottleneck(f"{q}.m.0", c_) + bottleneck(f"{q}.m.1", c_)
            else:
                out += site(f"{q}.cv1", c // 2, c, 3) + site(f"{q}.cv2", c, c // 2, 3)
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
        c2, c3, c1 = a["c2"], a["c3"], L.cin
        out = site(f"{p}.reg0", c2, c1, 3) + site(f"{p}.reg1", c2, c2, 3) \
            + site(f"{p}.cls_dw0", c1, 1, 3) + site(f"{p}.cls_pw0", c3, c1, 1) \
            + site(f"{p}.cls_dw1", c3, 1, 3) + site(f"{p}.cls_pw1", c3, c3, 1)
        out += [(f"{p}.reg_pred.weight", (4 * (a["reg_max"] + 1), c2, 1, 1)),
                (f"{p}.reg_pred.bias", (4 * (a["reg_max"] + 1),)),
                (f"{p}.cls_pred.weight", (a["nc"], c3, 1, 1)), (f"{p}.cls_pred.bias", (a["nc"],))]
    return out


def leaf_shapes(graph, nc: int) -> Dict[str, tuple]:
    """name -> shape of every folded leaf of the graph."""
    layers, _ = parse(graph, nc)
    return {name: shape for L in layers for name, shape in _layer_shapes(L)}
