"""Decode + NMS kernel (ops/greedy_nms.py, csrc/greedy_nms.cu): the bound
of every served batch's NMS, from the kept boxes of each image
(yardstick.nms_bound, 512 candidates an image on the fast path), over the
window's device time of nms_bitmatrix_kernel and nms_scan_kernel, in %."""
from portbench import yardstick as Y

KERNELS = ("nms_bitmatrix_kernel", "nms_scan_kernel")


def read(rec):
    if "kernel_us" not in rec or "kept_per_image" not in rec:
        return None
    ms = Y.kernel_ms(rec, KERNELS)
    if ms <= 0:
        return None
    kept, b = rec["kept_per_image"], rec["batch"]
    bound = sum(Y.nms_bound(kept[i:i + b]) for i in range(0, len(kept), b))
    return 100.0 * bound / ms
