"""Int8 depthwise convs (csrc/int8_dw.cu): the sum of every depthwise
site's int8 bound of a predict (yardstick.int8_bounds) over the device time
a batch of int8_dw_kernel, in %."""
from portbench import yardstick as Y

KERNELS = ("int8_dw_kernel",)


def read(rec):
    if rec.get("precision") != "int8" or "kernel_us" not in rec:
        return None
    ms = Y.kernel_ms(rec, KERNELS) / rec["batches"]
    if ms <= 0:
        return None
    return 100.0 * Y.int8_bounds(rec["config"], rec["batch"], rec["img"])["dw"] / ms
