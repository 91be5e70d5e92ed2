"""Deploy layers' convolutions (models/graph.py, models/blocks.py, cuDNN):
the device ms a batch of the kernels whose names hold one of KERNELS, the
convolution kernels that cuDNN runs for the bf16 deploy graph on the card."""
from portbench import yardstick as Y

# as the profiler names them on an H100 with torch 2.11 / cuDNN 9 (CUDA
# 12.8): cuDNN's depthwise and 1x1 direct kernels, its implicit-GEMM fprop
# kernels (xmma, cutlass), and the cuBLASLt GEMMs (nvjet, cutlass gemm) that
# it runs 1x1 convolutions on
KERNELS = ("conv2d_grouped_direct_kernel", "conv2d_c1_k1", "fprop", "nvjet_",
           "s16816gemm")


def read(rec):
    if rec.get("precision") != "bf16" or "kernel_us" not in rec:
        return None
    ms = Y.kernel_ms(rec, KERNELS) / rec["batches"]
    return ms if ms > 0 else None
