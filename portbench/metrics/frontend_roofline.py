"""Front-end kernel (ops/frontend.py, csrc/frontend.cu): the bound of
layers 0-2 of a batch (yardstick.frontend_bound) over the device time a
batch of frontend_kernel / frontend_mma_kernel, in %."""
from portbench import yardstick as Y

KERNELS = ("frontend_kernel", "frontend_mma_kernel")


def read(rec):
    if rec.get("precision") != "bf16" or "kernel_us" not in rec:
        return None
    ms = Y.kernel_ms(rec, KERNELS) / rec["batches"]
    if ms <= 0:
        return None
    return 100.0 * Y.frontend_bound(rec["config"], rec["batch"], rec["img"]) / ms
