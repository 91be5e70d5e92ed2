"""The YOLO11x configuration and its cell: the stored FLOPs against the
benchmark's own count and the published table, the benchmark's reference
(portbench/reference/yolo11.py) against the port's CPU path at 128 px,
serve_ref's binding of serve.py, control_ref's faults, and the new
readers on made-up records and on the traced card run kept in
portbench/tests/data/{record,spans}_yolo11x-serve-bf16.json."""
import json
import math
from pathlib import Path

import pytest
import torch

from portbench import compare, harness
from portbench.reference import deploy as D
from portbench.reference import yolo11 as RY

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELL = "yolo11x-serve-bf16"
PLAN = harness.cell_plan(BENCH, CELL)
CFG = PLAN["config"]
DATA = Path(__file__).parent / "data"


def reader(name):
    return harness.load_module(harness.ROOT / "portbench" / "metrics" / f"{name}.py", "r")


def images(seed, b, img):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, img, img, 3), generator=g, dtype=torch.uint8)


def test_stored_flops_are_the_shapes_and_the_published():
    """194,902,732,800: 2 x the deploy convs' multiply-adds at 640 (the
    attention's products left out, as Ultralytics counts), within 0.1% of
    the published 194.9 G; 56,919,408 parameters, the published 56.9 M."""
    assert CFG["deploy_flops_per_image"] == 2 * RY.count_macs(CFG, CFG["img_size"])
    assert math.isclose(CFG["deploy_flops_per_image"] / 1e9, CFG["published"]["gflops_640"],
                        rel_tol=1e-3)
    layers, _ = RY.parse(CFG["graph"], CFG["nc"])
    params = sum(math.prod(s) for s in RY.leaf_shapes(layers).values())
    assert params == 56_919_408
    assert math.isclose(params / 1e6, CFG["published"]["params_m"], rel_tol=1e-3)
    assert CFG["reduced"] == [] and CFG["reference"] == "yolo11" and CFG["reg_max"] == 15


def test_counts_of_the_new_metrics():
    """The attention's bound at bs32@640: 59.0 MB, 11.8 GFLOP (bytes-bound,
    0.0176 ms); the eight k 3 depthwise sites: 0.963 GB, 0.288 ms."""
    nbytes, ops = RY.attention_counts(CFG, 32, 640)
    assert nbytes == 2 * 32 * 6 * 400 * (2 * 32 + 2 * 64) * 2
    assert ops == 2 * 32 * 6 * 2 * 400 ** 2 * (32 + 64)
    sites = RY.dw_sites(CFG, 32, 640)
    assert sorted((w[0], x[2]) for x, w, _ in sites) == [
        (384, 20), (384, 20), (384, 20), (384, 40), (384, 80), (384, 80), (768, 20), (768, 40)]
    assert reader("dw_k3_roofline").dw_k3_bound(CFG, 32, 640) == pytest.approx(0.2876, abs=1e-3)


@pytest.fixture(scope="module")
def served():
    """The reference of YOLO11x at 128 px, its heads conditioned on 2
    images, and the port's f32 Evaler on the same weights."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    model = RY.Model(CFG, None)
    model.sd = RY.random_weights(model.layers, 7, "cpu")
    RY.condition_heads(model, images(1, 2, 128), 20, 0.001)
    tree = state_dict_to_train_variables({f"net.{k}": v for k, v in model.sd.items()})
    ev = Evaler(half=False, device="cpu", conf_thres=0.001, iou_thres=0.7, max_det=300)
    ev.init_model(CFG["graph"], {"params": tree["params"]}, nc=80, folded=True)
    return model, ev


def test_reference_forward_equals_the_ports(served):
    """f32 both sides, the same operations in another order: 1e-5 of the
    largest logit."""
    model, ev = served
    x = images(2, 2, 128)
    for (_, cls, reg), (cl, rg) in zip(ev.forward(x), model.levels(x)):
        rg = rg.permute(0, 2, 3, 1)
        assert torch.allclose(cls, torch.sigmoid(cl).permute(0, 2, 3, 1), atol=1e-5)
        assert torch.allclose(reg, rg, atol=1e-5 * rg.abs().max().item())


def test_reference_predict_equals_the_ports(served):
    model, ev = served
    x = images(3, 2, 128)
    got = ev.predict(x)
    scores, boxes = model.decoded(x)
    ref = D.nms(scores, boxes, 0.001, 0.7, 300)
    assert all(len(d["scores"]) > 5 for d in ref)
    for i, d in enumerate(ref):
        k = int(got["valid"][i].sum())
        assert k == len(d["scores"])
        assert torch.allclose(got["boxes"][i, :k], d["boxes"], atol=1e-3)
        assert torch.allclose(got["scores"][i, :k], d["scores"], atol=1e-5)
        assert torch.equal(got["classes"][i, :k], d["classes"])
    gaps = compare.detections(model, [(x, got)], PLAN["mix"])
    assert gaps["box_gap_px_max"] < 1e-3 and gaps["count_gap_max"] == 0


def test_serve_ref_binds_serve_to_the_configurations_reference():
    driver = harness.load_module(harness.ROOT / "portbench" / "drivers" / "serve_ref.py", "d")
    args = type("Args", (), dict(seed=1, seconds=1, trace=0))
    ctx = harness.Context(PLAN, args, 0.0, "cpu")
    serve = driver._serve(ctx)
    assert serve.R.Model is RY.Model and serve.R.random_weights is RY.random_weights
    assert serve.R.condition_heads.keywords == {"conf_thres": 0.001}
    assert "psa_attention" in serve.counters() and "greedy_nms" in serve.counters()
    assert set(PLAN["mix"]) <= serve.MIX_KEYS


def test_control_ref_plants_the_serve_faults():
    from portbench import faults
    ctl = harness.load_module(harness.ROOT / "portbench" / "control_ref.py", "c")
    for name in ("half_batch", "altered_answer"):
        with ctl.plant(name, "serve_ref"):
            pass
    with pytest.raises(KeyError):
        faults.plant("half_batch", "serve_ref")


KERNEL_FLASH = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 128, "
                "4, false, false, cutlass::bfloat16_t>, false, false>"
                "(pytorch_flash::Flash_fwd_params)")
KERNEL_DW = ("void (anonymous namespace)::dw_conv_kernel<__nv_bfloat16, 3>(__nv_bfloat16 const*, "
             "__nv_bfloat16 const*, void const*, __nv_bfloat16*, (anonymous namespace)::DwGeo)")


def made_up(kernel_us, config=CFG, precision="bf16", **extra):
    return {"precision": precision, "batches": 4, "batch": 32, "img": 640, "config": config,
            "kernel_us": kernel_us, **extra}


def test_new_readers_on_a_made_up_record():
    rec = made_up({KERNEL_FLASH: 200.0, KERNEL_DW: 4000.0, "void other_kernel()": 9.0},
                  counters={"psa_attention": 8})
    assert reader("attn_ms.serve").read(rec) == pytest.approx(0.05)
    nbytes, ops = RY.attention_counts(CFG, 32, 640)
    assert reader("attn_roofline").read(rec) == pytest.approx(
        100 * max(nbytes / 3.35e12, ops / 989e12) * 1e3 / 0.05)
    assert reader("attn_launches_per_batch").read(rec) == 2
    assert reader("dw_k3_roofline").read(rec) == pytest.approx(
        100 * reader("dw_k3_roofline").dw_k3_bound(CFG, 32, 640) / 1.0)


def test_new_readers_read_nothing_elsewhere():
    n_cfg = harness.cell_plan(BENCH, "n-serve-bf16")["config"]
    for rec in (made_up({KERNEL_DW: 1000.0}, config=n_cfg),            # N: no attention
                made_up({}, counters={}),                               # nothing ran
                made_up({KERNEL_FLASH: 1.0, KERNEL_DW: 1.0}, precision="int8"),
                {"precision": "bf16", "batches": 1}):                   # untraced
        for name in ("attn_ms.serve", "attn_roofline", "attn_launches_per_batch",
                     "dw_k3_roofline"):
            assert reader(name).read(rec) is None, name


@pytest.mark.parametrize("kind", ["record", "spans"])
def test_the_cells_traced_run_is_kept(kind):
    """The traced card run's record and span table are kept for
    test_pb_readers.py and test_pb_program_spans.py, which read them back."""
    kept = json.loads((DATA / f"{kind}_{CELL}.json").read_text())
    own = {m["name"] for m in PLAN["per_layer"]}
    if kind == "record":
        assert set(kept["metrics"]) == own
        assert kept["metrics"]["attn_launches_per_batch"]["value"] == 2
        for name in ("attn_roofline", "dw_k3_roofline", "mfu.serve"):
            assert 0 < kept["metrics"][name]["value"] <= 100
    else:
        assert set(kept["metrics"]) == {m["name"] for m in PLAN["per_layer"]
                                        if m["source"] == "program_span"}
