"""Deploy depthwise convs (csrc/dw_conv.cu) of a YOLO11 graph, all of
kernel size 3: the sum of the bounds of its k 3 depthwise sites
(reference/yolo11.py:dw_sites; YOLO11x: Detect's six and the two PSA
blocks' pe convs) over the device time a batch of dw_conv_kernel, in %. A
site's bound as dw_roofline's: bf16 activations in and out, bf16 weights
and an f32 bias once, 2 operations a multiply-add at the bf16 peak;
YOLO11x at bs32@640 0.963 GB, 0.288 ms."""
import math

from portbench import yardstick as Y
from portbench.reference import yolo11 as RY

KERNELS = ("dw_conv_kernel",)


def dw_k3_bound(config, batch: int, img: int) -> float:
    """ms: the sum of the k 3 depthwise sites' bounds."""
    return sum(Y.bound_ms(2 * math.prod(x) + 2 * math.prod(y) + 2 * math.prod(w) + 4 * w[0],
                          2 * math.prod(y) * w[2] * w[3], "bf16")
               for x, w, y in RY.dw_sites(config, batch, img, 3))


def read(rec):
    if rec.get("precision") != "bf16" or "kernel_us" not in rec \
            or rec.get("config", {}).get("reference") != "yolo11":
        return None
    ms = Y.kernel_ms(rec, KERNELS) / rec["batches"]
    if ms <= 0:
        return None
    return 100.0 * dw_k3_bound(rec["config"], rec["batch"], rec["img"]) / ms
