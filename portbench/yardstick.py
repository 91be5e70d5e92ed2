"""The benchmark's yardstick: the card's published peaks, the least time a
piece of work could take (a roofline bound), the operations and bytes of
each measured kernel counted from a configuration's shapes, and the union
of device spans that the idle share is read from.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit. Bound =
the larger of bytes / HBM bandwidth and operations / peak. Bytes count each
input read once and each output written once; operations are 2 a
multiply-add. Nothing here imports the program.
"""
from __future__ import annotations

import math

from portbench.reference import deploy as R
from portbench.reference.graph import parse

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def bound_ms(nbytes: float, ops: float, kind: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK[kind]) * 1e3


def span_union(spans):
    """(microseconds covered by the union of sorted (start, end, name)
    spans, microseconds by name)."""
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    return busy, by_name


def int8_bounds(config, batch: int, img: int):
    """{"conv": ms, "dw": ms}: the sum over an int8 predict's sites of each
    site's bound, bf16 activations in and out, int8 weights, int8 peak. The
    dense sites are every conv but the head's prediction convs (which stay
    float); the depthwise sites have groups > 1."""
    out = {"conv": 0.0, "dw": 0.0}
    for x, w, y, groups, act in R.shapes_of_convs(config, batch, img):
        if act == "pred":
            continue
        nbytes = 2 * math.prod(x) + 2 * math.prod(y) + math.prod(w)
        ops = 2 * math.prod(y) * w[1] * w[2] * w[3]
        out["dw" if groups > 1 else "conv"] += bound_ms(nbytes, ops, "int8")
    return out


def frontend_bound(config, batch: int, img: int) -> float:
    """Layers 0-2 (RepVGG 3x3/2, RepVGG 3x3/2, RepHDW) in bf16 with no halo
    recompute: the uint8 image in, layer 2's output out, the f32 weights
    once; operations of every conv of the three layers."""
    layers, _ = parse(config["graph"], config["nc"])
    l0, l1, l2 = layers[:3]
    c0, c1, c2 = l0.cout, l1.cout, l2.cout
    c_, mid, k, depth = l2.args["c_"], l2.args["mid"], l2.args["k"], l2.args["depth"]
    p0, p1 = batch * (img // 2) ** 2, batch * (img // 4) ** 2
    per_px1 = 9 * c0 * c1 + c1 * 2 * c_ + depth * (2 * c_ * mid + k * k * mid) \
        + (2 + depth) * c_ * c2
    fma = p0 * 27 * c0 + p1 * per_px1
    weights = 4 * (27 * c0 + per_px1)
    return bound_ms(batch * img * img * 3 + p1 * c2 * 2 + weights, 2 * fma, "bf16")


def nms_bound(kept_per_image, m: int = 512) -> float:
    """Greedy NMS of one batch: the candidates' f32 boxes and valid bytes
    read and the keep bytes written (m a image), and the IoU tests that the
    kept boxes need at least, each kept box against every earlier kept box
    (about 16 f32 operations a test)."""
    nbytes = len(kept_per_image) * m * (16 + 2)
    ops = 16 * sum(k * (k - 1) // 2 for k in kept_per_image)
    return bound_ms(nbytes, ops, "f32")


def kernel_ms(record, patterns) -> float:
    """Device ms over the traced window of the kernels whose names hold any
    of `patterns`."""
    return sum(us for name, us in record["kernel_us"].items()
               if any(p in name for p in patterns)) / 1e3
