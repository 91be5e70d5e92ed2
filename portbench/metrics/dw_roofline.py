"""Deploy depthwise convs (csrc/dw_conv.cu): the sum of the bounds of the
bf16 graph's depthwise sites outside layers 0-2 (which the front-end kernel
runs) over the device time a batch of dw_conv_kernel, in %. A site's bound:
bf16 activations in and out, bf16 weights and an f32 bias once, 2
operations a multiply-add at the bf16 peak, whatever kernel runs it."""
import math

from portbench import yardstick as Y
from portbench.reference import deploy as R
from portbench.reference.graph import parse

KERNELS = ("dw_conv_kernel",)


def dw_bound(config, batch: int, img: int) -> float:
    """ms: the depthwise sites' bounds past the front-end's layers 0-2 (the
    first convs of the forward, in its order)."""
    layers, _ = parse(config["graph"], config["nc"])
    front = len(R.conv_leaves(layers[:3]))
    total = 0.0
    for x, w, y, groups, _ in R.shapes_of_convs(config, batch, img)[front:]:
        if groups > 1:
            nbytes = 2 * math.prod(x) + 2 * math.prod(y) + 2 * math.prod(w) + 4 * w[0]
            total += Y.bound_ms(nbytes, 2 * math.prod(y) * w[2] * w[3], "bf16")
    return total


def read(rec):
    if rec.get("precision") != "bf16" or "kernel_us" not in rec:
        return None
    ms = Y.kernel_ms(rec, KERNELS) / rec["batches"]
    if ms <= 0:
        return None
    return 100.0 * dw_bound(rec["config"], rec["batch"], rec["img"]) / ms
