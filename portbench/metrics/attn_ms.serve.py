"""PSA attention (ops/attention.py): the device ms a batch of the attention
op's fused kernels, FlashAttention's (`flash_fwd*`) that the op takes on
the card in bf16. The zero padding of q and k runs in elementwise kernels
outside this time."""
from portbench import yardstick as Y

KERNELS = ("flash_fwd",)


def read(rec):
    if rec.get("precision") != "bf16" or "kernel_us" not in rec:
        return None
    ms = Y.kernel_ms(rec, KERNELS) / rec["batches"]
    return ms if ms > 0 else None
