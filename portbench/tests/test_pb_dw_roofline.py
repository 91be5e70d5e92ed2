"""dw_roofline's reader on small records made up for it: the depthwise
sites' bound past layers 0-2 over the kernel's ms a batch, and nothing
where the kernel did not run or the precision is int8."""
import json
import math

import pytest

from portbench import harness
from portbench.reference import deploy as R

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
KERNEL = ("void (anonymous namespace)::dw_conv_kernel<__nv_bfloat16, 5>(__nv_bfloat16 const*, "
          "__nv_bfloat16 const*, void const*, __nv_bfloat16*, (anonymous namespace)::DwGeo)")
CUDNN = "void cudnn::cnn::conv2d_grouped_direct_kernel<false, true>(int)"


def reader():
    return harness.load_module(harness.ROOT / "portbench" / "metrics" / "dw_roofline.py", "dw")


def record(precision, kernel_us, batch=32, img=640):
    plan = harness.cell_plan(BENCH, "n-serve-bf16")
    return {"precision": precision, "batches": 4, "batch": batch, "img": img,
            "config": plan["config"], "kernel_us": kernel_us}


def test_bound_is_the_15_sites_past_the_front_end():
    """N at bs32@640: 0.272 ms, the 16 depthwise sites' bytes less layer
    2's k3 site (bf16 in and out, bf16 weights, f32 bias; bytes-bound)."""
    config = record("bf16", {})["config"]
    dw = [(x, w, y) for x, w, y, g, _ in R.shapes_of_convs(config, 32, 640) if g > 1]
    assert len(dw) == 16 and dw[0][1][2] == 3
    want = sum((2 * math.prod(x) + 2 * math.prod(y) + 2 * math.prod(w) + 4 * w[0]) / 3.35e12
               for x, w, y in dw[1:]) * 1e3
    assert reader().dw_bound(config, 32, 640) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(0.272, abs=5e-4)


def test_reads_the_kernels_ms_a_batch():
    rec = record("bf16", {KERNEL: 1500.0, KERNEL.replace(", 5>", ", 9>"): 500.0, CUDNN: 9.0})
    bound = reader().dw_bound(rec["config"], 32, 640)
    assert reader().read(rec) == pytest.approx(100.0 * bound / 0.5, rel=1e-12)


@pytest.mark.parametrize("rec", [
    record("bf16", {CUDNN: 4753.0}),                 # no kernel: cuDNN runs the sites
    record("int8", {KERNEL: 1000.0}),
    {"precision": "bf16", "batches": 1},             # no trace
], ids=["kernel_absent", "int8", "untraced"])
def test_reads_nothing_without_the_kernel(rec):
    assert reader().read(rec) is None
