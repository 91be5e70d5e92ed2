"""Int8 dense convs (ops/quant_conv.py, csrc/int8_conv.cu,
csrc/int8_conv3x3.cuh): the sum of every dense site's int8 bound of a
predict (yardstick.int8_bounds) over the device time a batch of
int8_conv_kernel and conv3x3_kernel, in %."""
from portbench import yardstick as Y

KERNELS = ("int8_conv_kernel", "conv3x3_kernel")


def read(rec):
    if rec.get("precision") != "int8" or "kernel_us" not in rec:
        return None
    ms = Y.kernel_ms(rec, KERNELS) / rec["batches"]
    if ms <= 0:
        return None
    return 100.0 * Y.int8_bounds(rec["config"], rec["batch"], rec["img"])["conv"] / ms
