"""YOLO11 in the port (models/yolo11.py, the C3k2 / C2PSA / Head_Detect
blocks, their parse and folds, ops/attention.py) against the plain
reference reference/yolo11.py, on the CPU in f32 at 64-128 px.

Weights are the port's seeded random trees (utils/bridge.py), fed to the
reference under the same leaf names (the state_dict without `net.`). The
tolerances compare one f32 computation with another that runs the same
operations in another order (MKL-DNN's conv algorithms against F.conv2d's,
torch's fused attention against matmul-softmax-matmul, BN folded into the
weights against BN after the conv): a few f32 ulps of the largest value,
1e-5 of it, well under any error of the model's mathematics (a swapped
branch or a wrong channel order moves the outputs by their own scale)."""
import math

import pytest
import torch

from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.graph import parse_graph
from mafyolo_tpu_torch.models.reparam import fold_variables
from mafyolo_tpu_torch.models.yolo11 import yolo11_graph
from mafyolo_tpu_torch.ops import attention
from mafyolo_tpu_torch.utils.bridge import (folded_to_state_dict, random_train_variables,
                                            train_variables_to_state_dict)
from mafyolo_tpu_torch.utils.sample import random_deploy_tree
from reference import yolo11 as RY

NC = 80
REL = 1e-5      # of the largest reference value: see the module docstring


def images(seed, b, img):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, img, img, 3), generator=g, dtype=torch.uint8)


def small_graph(rows, scale="n", width=1.0):
    """A graph of a stem Conv, `rows`, and a one-level Detect head on the
    last row (stride of the map it reads)."""
    body = [[-1, 1, "Conv", [64, 3, 2]]] + rows
    n = len(body)
    return dict(scale=scale, depth_multiple=1.0, width_multiple=width, max_channels=1024,
                backbone=body, neck=[],
                effidehead=[[n - 1, 1, "Head_Detect", [15]], [[n], 1, "Out", []]])


def both_forms(graph, seed):
    """(train-form model in eval, deploy model on the folded tree, the
    reference's train leaves) of a graph, from one seeded random tree."""
    specs, _, _ = parse_graph(graph, NC)
    v = random_train_variables(specs, seed)
    sd = train_variables_to_state_dict(v)
    train = build_model(graph, nc=NC).eval()
    train.load_state_dict(sd)
    deploy = build_model(graph, nc=NC, deploy=True).eval()
    deploy.load_state_dict(folded_to_state_dict(fold_variables(specs, v)))
    return train, deploy, {k[len("net."):]: t for k, t in sd.items()}


def assert_levels_equal(port_levels, ref_levels):
    """Port (feat, sigmoid(cls), reg) NHWC against reference (cls, reg)
    logits NCHW: the scores and the regression logits."""
    for (_, cls, reg), (rc, rr) in zip(port_levels, ref_levels):
        rc, rr = torch.sigmoid(rc).permute(0, 2, 3, 1), rr.permute(0, 2, 3, 1)
        assert cls.shape == rc.shape and reg.shape == rr.shape
        assert torch.allclose(cls, rc, atol=REL * rc.abs().max().item(), rtol=0)
        assert torch.allclose(reg, rr, atol=REL * rr.abs().max().item(), rtol=0)


# ---- the x graph at published widths


@pytest.fixture(scope="module")
def x_deploy():
    return build_model(yolo11_graph("x"), nc=NC, deploy=True)


def test_x_graph_rows_take_the_published_widths(x_deploy):
    want = [96, 192, 384, 384, 768, 768, 768, 768, 768, 768, 768,     # backbone 0-10
            768, 1536, 768, 768, 1536, 384, 384, 1152, 768, 768, 1536, 768]
    specs = x_deploy.specs
    assert [s.cout for s in specs[:23]] == want
    assert [s.kind for s in specs[23:]] == ["Head_Detect"] * 3 + ["Out"]
    assert all(s.kw["c3k"] and s.kw["n"] == 2 for s in specs if s.kind == "C3k2")
    assert [s.kw["e"] for s in specs if s.kind == "C3k2"][:2] == [0.25, 0.25]
    heads = [s.kw for s in specs if s.kind == "Head_Detect"]
    assert [(h["cin"], h["c2"], h["c3"], h["reg_max"]) for h in heads] == [
        (384, 96, 384, 15), (768, 96, 384, 15), (768, 96, 384, 15)]
    psa = x_deploy.net.layer10.m
    assert len(psa) == 2 and psa[0].attn.num_heads == 6
    assert (psa[0].attn.key_dim, psa[0].attn.head_dim) == (32, 64)
    assert x_deploy.reg_max == 15 and x_deploy.out_frm == (23, 24, 25)


def test_x_graph_params_and_flops_are_the_published(x_deploy):
    """56,919,408 deploy parameters (the published 56.9 M less the DFL's 16
    fixed weights) and 194.90 GFLOPs at 640 (2 x the convs' multiply-adds,
    the attention's products left out, as Ultralytics counts)."""
    params = sum(p.numel() for p in x_deploy.parameters())
    assert params == 56_919_408
    assert params / 1e6 == pytest.approx(56.9, rel=1e-3)
    model = build_model(yolo11_graph("x"), nc=NC, deploy=True).to("meta")
    macs = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(lambda mod, a, y: macs.append(
                y.numel() * mod.in_channels // mod.groups * math.prod(mod.kernel_size)))
    with torch.no_grad():
        model(torch.empty(1, 640, 640, 3, device="meta"))
    flops = 2 * sum(macs)
    assert flops == 2 * RY.count_macs(yolo11_graph("x"), NC, 640) == 194_902_732_800
    assert flops / 1e9 == pytest.approx(194.9, rel=1e-3)


def test_x_graph_leaves_are_the_references(x_deploy):
    got = {k[len("net."):]: tuple(t.shape) for k, t in x_deploy.state_dict().items()}
    assert got == RY.leaf_shapes(yolo11_graph("x"), NC)


def test_scale_rule_caps_and_forces_c3k():
    """n: no cap at 1024, c3k as the yaml writes it; m: the 512 cap and
    every C3k2 with C3k blocks."""
    specs, _, _ = parse_graph(yolo11_graph("n"), NC)
    assert [s.cout for s in specs[:11]] == [16, 32, 64, 64, 128, 128, 128, 256, 256, 256, 256]
    assert [s.kw["c3k"] for s in specs if s.kind == "C3k2"] == [False, False, True, True,
                                                                False, False, False, True]
    assert all(s.kw["n"] == 1 for s in specs if s.kind in ("C3k2", "C2PSA"))
    specs, _, _ = parse_graph(yolo11_graph("m"), NC)
    assert specs[7].cout == 512 and specs[10].cout == 512
    assert all(s.kw["c3k"] for s in specs if s.kind == "C3k2")


# ---- each block against the reference


BLOCK_GRAPHS = {
    "c3k2_bottleneck": small_graph([[-1, 2, "C3k2", [64, False, 0.5]]], scale="n"),
    "c3k2_c3k": small_graph([[-1, 2, "C3k2", [64, True, 0.5]]], scale="n"),
    "c3k2_forced_c3k": small_graph([[-1, 1, "C3k2", [96, False, 0.25]]], scale="x"),
    "c2psa_1": small_graph([[-1, 1, "Conv", [256, 3, 2]], [-1, 1, "C2PSA", [256]]]),
    "c2psa_2": small_graph([[-1, 1, "Conv", [256, 3, 2]], [-1, 2, "C2PSA", [256]]]),
    "sppf_detect": small_graph([[-1, 1, "Conv", [128, 3, 2]], [-1, 1, "SPPF", [128, 5]]]),
}


@pytest.mark.parametrize("name", sorted(BLOCK_GRAPHS))
def test_block_against_the_reference(name):
    """Train form (BN in eval) against the reference's train form, and the
    deploy form on the port's fold against the reference's folded forward
    on the reference's own fold; the Detect head reads every block."""
    graph = BLOCK_GRAPHS[name]
    train, deploy, ref_sd = both_forms(graph, seed=3)
    layers, heads = RY.parse(graph, NC)
    x = images(1, 2, 64)
    with torch.no_grad():
        got_train, got_deploy = train(x.flip(-1).float() / 255), deploy(x.flip(-1).float() / 255)
    with RY.run():
        want_train = RY.forward(ref_sd, layers, heads, RY.to_input(x), "train")
        want_folded = RY.forward(RY.fold(ref_sd), layers, heads, RY.to_input(x), "folded")
    assert_levels_equal(got_train, want_train)
    assert_levels_equal(got_deploy, want_folded)


def _attention_per_tensor(att, x):
    """The attention with q, k and v split per tensor (q the first heads x
    key_dim channels, then k, then v): the layout Ultralytics does NOT use."""
    b, c, h, w = x.shape
    nh, kd, hd = att.num_heads, att.key_dim, att.head_dim
    qkv = att.qkv(x).reshape(b, -1, h * w)
    q = qkv[:, :nh * kd].reshape(b, nh, kd, h * w)
    k = qkv[:, nh * kd:2 * nh * kd].reshape(b, nh, kd, h * w)
    v = qkv[:, 2 * nh * kd:].reshape(b, nh, hd, h * w)
    a = ((q.transpose(-2, -1) @ k) * att.scale).softmax(-1)
    y = (v @ a.transpose(-2, -1)).reshape(b, c, h, w) + att.pe(v.reshape(b, c, h, w))
    return att.proj(y)


def test_attention_interleaves_q_k_v_per_head():
    """A PSA attention of 2 heads (dim 128): the port equals the reference
    (q, k, v interleaved a head: [B, heads, 2 kd + hd, N]) and is far from
    the same weights split per tensor, so the comparison tells them apart."""
    graph = small_graph([[-1, 1, "Conv", [256, 3, 2]], [-1, 1, "C2PSA", [256]]])
    _, deploy, _ = both_forms(graph, seed=5)
    att = deploy.net.layer2.m[0].attn
    assert att.num_heads == 2
    x = torch.randn(2, 128, 4, 4)
    layers, _ = RY.parse(graph, NC)
    sd = {k[len("net."):]: t for k, t in deploy.state_dict().items()}
    with torch.no_grad(), RY.run():
        got = att(x)
        p = "layer2.m.0.attn"
        qkv = torch.nn.functional.conv2d(x, sd[f"{p}.qkv.conv.weight"], sd[f"{p}.qkv.conv.bias"])
        q, k, v = qkv.view(2, 2, 128, 16).split([32, 32, 64], dim=2)
        a = ((q.transpose(-2, -1) @ k) * 32 ** -0.5).softmax(-1)
        y = (v @ a.transpose(-2, -1)).view(2, 128, 4, 4) + torch.nn.functional.conv2d(
            v.reshape(2, 128, 4, 4), sd[f"{p}.pe.conv.weight"], sd[f"{p}.pe.conv.bias"],
            padding=1, groups=128)
        want = torch.nn.functional.conv2d(y, sd[f"{p}.proj.conv.weight"], sd[f"{p}.proj.conv.bias"])
        wrong = _attention_per_tensor(att, x)
    scale = want.abs().max().item()
    assert torch.allclose(got, want, atol=REL * scale, rtol=0)
    assert (wrong - want).abs().max().item() > 0.05 * scale


def test_psa_attention_counts_its_calls():
    q, k, v = torch.randn(2, 3, 5, 4), torch.randn(2, 3, 5, 4), torch.randn(2, 3, 5, 8)
    before = attention.psa_attention.launches
    out = attention.psa_attention(q, k, v, 0.5)
    assert attention.psa_attention.launches == before + 1
    want = torch.softmax(q @ k.transpose(-2, -1) * 0.5, -1) @ v
    assert torch.allclose(out, want, atol=1e-6)
    attention.psa_attention(q[:0], k[:0], v[:0], 0.5)          # an empty batch: no launch
    assert attention.psa_attention.launches == before + 1
    from mafyolo_tpu_torch.core.graphs import COUNTERS
    assert (attention.psa_attention, "launches") in COUNTERS
    with pytest.raises(ValueError):
        attention.psa_attention(q, k[..., :3], v, 0.5)


def test_the_smoke_names_the_kernels_of_every_counter():
    """chip_smoke.py's graphs_check holds each launch counter of
    core/graphs.py:COUNTERS to the kernels the profiler saw, by the names in
    its COUNTED_KERNELS: a counter without names there fails every path."""
    import chip_smoke
    from mafyolo_tpu_torch.core.graphs import COUNTERS
    assert {f"{fn.__name__}.{attr}" for fn, attr in COUNTERS} == set(chip_smoke.COUNTED_KERNELS)


def test_the_smokes_attention_check_passes_and_has_teeth(monkeypatch):
    """chip_smoke.py:psa_check at YOLO11x's attention shapes (batch 2) on the
    CPU, where psa_attention is torch's own: both dtypes within PSA_TOL of
    the plain f32 attention, and the wrong scale (64^-0.5) rejected with
    room (its check would fail at tolerances ten times as loose). The card
    timings are not taken here (graph_ms replaced by a plain call)."""
    import chip_smoke
    from mafyolo_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "graph_ms", lambda fn, iters=20: (fn(), 0.0)[1])
    rec = chip_smoke.psa_check(torch.device("cpu"), batch=2)
    for tag in ("bf16", "f32"):
        assert rec[tag]["err_over_tol"] <= 1.0
        assert rec[tag]["scale_fault_over_tol"] > 10.0


# ---- the whole model at scale n


@pytest.fixture(scope="module")
def scale_n():
    return both_forms(yolo11_graph("n"), seed=11)


def test_fold_equals_the_train_form_in_eval(scale_n):
    train, deploy, ref_sd = scale_n
    x = images(2, 2, 96).flip(-1).float() / 255
    with torch.no_grad():
        for (_, c1, r1), (_, c2, r2) in zip(train(x), deploy(x)):
            assert torch.allclose(c1, c2, atol=REL * c1.abs().max().item(), rtol=0)
            assert torch.allclose(r1, r2, atol=REL * r1.abs().max().item(), rtol=0)
    folded = RY.fold(ref_sd)
    got = {k[len("net."):]: t for k, t in deploy.state_dict().items()}
    assert set(got) == set(folded)
    for k, t in folded.items():
        assert torch.allclose(got[k], t, atol=1e-6 * max(t.abs().max().item(), 1.0)), k


def _conditioned_tree(graph, seed, imgs, pairs):
    """A folded tree whose heads give detections: classes 0 and 1 live, their
    logits z over `imgs` recentred and scaled, a (z - mean) + c with a =
    2.5 / std(z) and c such that about `pairs` (anchor, class) pairs an
    image clear 0.001; the other 78 classes a zero row and bias -30."""
    specs, _, heads = parse_graph(graph, NC)
    folded = random_deploy_tree(specs, seed)
    sd = {k[len("net."):]: t for k, t in folded_to_state_dict(folded).items()}
    layers, hl = RY.parse(graph, NC)
    with RY.run():
        levels = RY.forward(sd, layers, hl, RY.to_input(imgs))
    z = torch.cat([c[:, :2].flatten() for c, _ in levels]).double()
    a = 2.5 / z.std().item()
    c = math.log(0.001 / 0.999) - (a * (z - z.mean())).sort(descending=True).values[
        pairs * imgs.shape[0]].item()
    for i in heads:
        pred = folded["params"]["net"][f"layer{i}"]["cls_pred"]
        pred["kernel"][..., :2] *= a
        pred["kernel"][..., 2:] = 0.0
        pred["bias"][:2] = a * (pred["bias"][:2] - z.mean().item()) + c
        pred["bias"][2:] = -30.0
    return folded


def test_predict_eager_against_the_references_nms():
    """Scale n at 128 px through Evaler.predict_eager (f32, the model's own
    layers, decode, the NMS kernel's plain version) against the reference's
    folded forward, decode and greedy NMS, at Ultralytics' val thresholds."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    graph = yolo11_graph("n")
    folded = _conditioned_tree(graph, 13, images(20, 2, 128), pairs=40)
    ev = Evaler(half=False, device="cpu", conf_thres=0.001, iou_thres=0.7, max_det=300)
    ev.init_model(graph, folded, nc=NC, folded=True)
    assert ev.fe_skip == -1 and ev.model.reg_max == 15
    x = images(21, 2, 128)
    before = attention.psa_attention.launches
    got = ev.predict_eager(x)
    assert attention.psa_attention.launches == before + 1          # one PSA block at n
    sd = {k[len("net."):]: t for k, t in folded_to_state_dict(folded).items()}
    ref, _ = RY.predict(sd, graph, NC, x, conf=0.001, iou_thres=0.7, max_det=300)
    assert all(len(d["scores"]) > 10 for d in ref)
    for i, d in enumerate(ref):
        k = int(got["valid"][i].sum())
        assert k == len(d["scores"])
        # boxes in px up to 128: f32 sums in another order, some 1e-5 px
        assert torch.allclose(got["boxes"][i, :k], d["boxes"], atol=1e-3)
        assert torch.allclose(got["scores"][i, :k], d["scores"], atol=1e-5)
        assert torch.equal(got["classes"][i, :k], d["classes"])


# ---- what refuses a YOLO11 graph


def test_int8_paths_refuse_the_graph():
    from mafyolo_tpu_torch.core.quant import int8_predict_fn, ptq_calibrate
    graph = yolo11_graph("n")
    specs, _, _ = parse_graph(graph, NC)
    folded = fold_variables(specs, random_train_variables(specs, 1))
    with pytest.raises(NotImplementedError, match="YOLO11"):
        build_model(graph, nc=NC, deploy=True, quant=True)
    with pytest.raises(NotImplementedError, match="YOLO11"):
        ptq_calibrate(graph, NC, folded, [images(1, 1, 64)], device="cpu")
    with pytest.raises(NotImplementedError, match="YOLO11"):
        int8_predict_fn(graph, NC, folded, {}, device="cpu")


def test_train_step_refuses_the_graph():
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    model = build_model(yolo11_graph("n"), nc=NC)
    state = init_train_state(model, weight_decay=5e-4)
    step = make_train_step(num_classes=NC, img_size=64, reg_max=15)
    targets = torch.zeros(1, 1, 5)
    with pytest.raises(NotImplementedError, match="YOLO11"):
        step(state, images(1, 1, 64), targets, 0.01, 0.01, 0.01, 0.9, True, False)
