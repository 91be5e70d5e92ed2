"""The deploy depthwise kernel's CPU side (ops/dw_deploy.py): its tiled
formulation against F.conv2d in f32 (any difference is summation order: at
most k^2 products of unit-size terms, atol 1e-5), the tile planner at every
depthwise site of N's, S's and M's predict, and the routing rule that
models/blocks.py:ConvAct applies. The kernel itself runs only on the card
(tests/test_torch_gpu.py); here a tensor claims the card by a stand-in that
carries x's dtype and a CUDA device, and the op runs its plain version."""
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from mafyolo_tpu_torch.core import quant as Q
from mafyolo_tpu_torch.models import blocks as B
from mafyolo_tpu_torch.ops import dw_deploy as DD
from mafyolo_tpu_torch.ops import quant_conv as QC
from mafyolo_tpu_torch.utils.sample import deploy_dw_sites
from torch_common import port_model, random_folded, u8_images

NC = 7


def _inputs(seed, b, c, h, w, k):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(0, 1, (b, c, h, w)) + 0.3).astype(np.float32))
    wt = torch.from_numpy(rng.normal(0, 1 / k, (c, 1, k, k)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32))
    return x.contiguous(memory_format=torch.channels_last), wt, bias


# 23 x 19 images cut into 8 x 12 tiles: every tile meets an image border or
# a ragged edge; and the planner's own tile (the whole image here)
@pytest.mark.parametrize("act", [None, "silu", "relu"])
@pytest.mark.parametrize("c", [72, 192, 341, 512])
@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_tiles_plain_matches_conv2d(k, c, act):
    x, wt, bias = _inputs(k * 1000 + c, 2, c, 23, 19, k)
    want = DD.ACTS[act](F.conv2d(x, wt, bias, padding=k // 2, groups=c))
    for tile in ((8, 12), None, (23, 19), (5, 19)):
        got = DD.dw_conv_tiles_plain(x, wt, bias, act, tile)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_on_the_cpu_is_the_plain_version(dtype):
    """mafyolo::dw_conv on a CPU tensor: the plain version (f32 conv and
    bias, one cast), channels_last like the kernel's output, no launch."""
    x, wt, bias = _inputs(5, 2, 33, 9, 11, 5)
    x, wt = x.to(dtype), wt.to(dtype)
    before = DD.dw_conv.launches
    got = DD.dw_conv(x, wt, bias, "silu")
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, DD.dw_conv_plain(x, wt, bias, "silu"))
    assert DD.dw_conv.launches == before
    with pytest.raises(ValueError):
        DD.dw_conv(x, wt, bias, "gelu")
    with pytest.raises(ValueError):
        DD.dw_conv(x, wt[:, :, :4, :4], bias)


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
def test_tile_planner_fits_every_site(name):
    """Every depthwise site of the model's predict at 640 px (the shapes are
    those at 64 px times 10): in bf16 the planner's block fits two an SM of
    the H100's shared memory, in f32 one; its tiles cover the image, and
    the whole image is one tile at 20 px. N has 15 sites past the
    front-end, 9 with a fused SiLU."""
    sites = deploy_dw_sites(name, 64, "cpu")
    for (c, h, w, k, act), count, front in sites:
        h, w = 10 * h, 10 * w
        th, tw = DD.dw_tile(k, h, w, 2)
        assert DD.smem_bytes(k, th, tw, 2) <= DD.SMEM_LIMIT <= (227 * 1024) // 2
        assert 0 < th <= h and 0 < tw <= w
        assert (th, tw) == (h, w) or max(th, tw) == DD.TILE[k]
        if h == 20:
            assert (th, tw) == (20, 20)
        th, tw = DD.dw_tile(k, h, w, 4)
        assert DD.smem_bytes(k, th, tw, 4) <= DD.SMEM_MAX == 227 * 1024
        assert 0 < th <= h and 0 < tw <= w
    if name == "maf-yolo-n":
        past = [(s, n) for s, n, front in sites if not front]
        assert sum(n for _, n in past) == 15
        assert sum(n for s, n in past if s[4] == "silu") == 9
        assert {s[3] for s, _ in past} == {5, 7, 9}


def _on_card(x):
    """A stand-in for x that the routing rule reads as a CUDA tensor."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=x.dtype,
                                 requires_grad=x.requires_grad)


@pytest.mark.parametrize("case,taken", [
    ("dw_k5", True), ("dw_k9_f32", True), ("dw_k1", False), ("no_bias", False),
    ("stride2", False), ("dilation2", False), ("k11", False), ("even_k", False), ("pad0", False),
    ("grouped", False), ("dense", False), ("fp16", False), ("weight_dtype", False),
    ("cpu", False), ("grad", False), ("quant", False)])
def test_routing_rule(case, taken):
    c, k, stride, dil, groups, pad, dtype = 16, 5, 1, 1, 16, None, torch.bfloat16
    cout = c
    if case == "dw_k9_f32":
        k, dtype = 9, torch.float32
    if case == "dw_k1":
        k = 1
    if case == "stride2":
        stride = 2
    if case == "dilation2":
        dil, pad = 2, 4
    if case == "k11":
        k = 11
    if case == "even_k":
        k, pad = 4, 2
    if case == "pad0":
        pad = 0
    if case == "grouped":
        groups = 4
    if case == "dense":
        groups = 1
    if case == "fp16":
        dtype = torch.float16
    cls = B.QuantConv2d if case == "quant" else nn.Conv2d
    conv = cls(c, cout, k, stride, k // 2 * dil if pad is None else pad, dilation=dil,
               groups=groups, bias=case != "no_bias").to(dtype)
    x = torch.zeros(1, c, 8, 8, dtype=torch.float32 if case == "weight_dtype" else dtype)
    if case == "weight_dtype":
        conv = conv.to(torch.bfloat16)
    probe = x if case == "cpu" else _on_card(x)
    if case == "grad":
        assert DD.takes_kernel(conv, probe) is False
        with torch.no_grad():
            assert DD.takes_kernel(conv, probe) is True
        return
    with torch.no_grad():
        assert DD.takes_kernel(conv, probe) is taken


@pytest.fixture
def routed(monkeypatch):
    """ConvAct's routing with every tensor claiming the card: the op runs its
    plain version; the calls are recorded as (C, k, act)."""
    real, op = DD.takes_kernel, DD.dw_conv
    calls = []

    def record(x, weight, bias, act=None):
        calls.append((x.shape[1], weight.shape[-1], act))
        return op(x, weight, bias, act)
    monkeypatch.setattr(DD, "takes_kernel", lambda conv, x: real(conv, _on_card(x)))
    monkeypatch.setattr(DD, "dw_conv", record)
    return calls


def test_deploy_forward_routed_equals_unrouted(routed):
    """N's deploy forward (the model's own layers 0-2 included) with every
    depthwise conv on the op, its SiLU fused, against the unrouted forward:
    16 calls, 10 with SiLU; f32 heads within 1e-4."""
    model = port_model("maf-yolo-n", NC, random_folded("maf-yolo-n", NC))
    x = torch.from_numpy(u8_images(3, (2, 64, 64, 3))).float() / 255
    with torch.no_grad():
        got = model(x)
    assert len(routed) == 16 and sum(a == "silu" for *_, a in routed) == 10
    assert {a for *_, a in routed} == {None, "silu"}
    routed.clear()
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(DD, "takes_kernel", lambda conv, x: False)
        want = model(x)
    assert not routed
    for g_level, w_level in zip(got, want):
        for g, w in zip(g_level, w_level):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


def test_replk_deploy_routes_its_relu(routed):
    """ReparamLargeKernelConv's deploy conv takes its ReLU into the op at
    stride 1; at stride 2 the conv and the ReLU stay torch's."""
    for stride, n_calls in ((1, 1), (2, 0)):
        m = B.ReparamLargeKernelConv(8, 7, stride, deploy=True).eval()
        x = torch.randn(2, 8, 12, 12)
        with torch.no_grad():
            got = m(x)
            want = F.relu(m.fused.conv(x))
        assert len(routed) == n_calls and all(a == "relu" for *_, a in routed)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        routed.clear()


def test_train_form_and_grad_keep_their_path(routed):
    """The train form (DWConv through ops/dwconv.py) and a deploy forward
    with autograd on never reach the op."""
    train = B.DepthBottleneckUni(8, 8, 5).train()
    train(torch.randn(2, 8, 10, 10)).sum().backward()
    deploy = B.DepthBottleneckUni(8, 8, 5, deploy=True).eval()
    deploy(torch.randn(2, 8, 10, 10)).sum().backward()
    assert routed == []


@pytest.fixture(scope="module")
def n_quant():
    folded = random_folded("maf-yolo-n", NC)
    imgs = u8_images(4, (2, 64, 64, 3))
    tree = Q.ptq_calibrate("maf-yolo-n", NC, folded, [imgs], max_batches=1, device="cpu")
    return folded, tree, torch.from_numpy(imgs).float() / 255


@pytest.mark.parametrize("mode", ["calib", "fake", "int8"])
def test_quant_modes_keep_their_path(routed, monkeypatch, n_quant, mode):
    """Every QuantConv2d mode bypasses the op. int8 launches what it did:
    16 int8_dw calls, SiLU after the 10 bottleneck ones (torch's, not fused)."""
    folded, tree, x = n_quant
    model = Q.quant_model("maf-yolo-n", NC, folded, tree, mode=mode, device="cpu")
    dw_calls, silu_after = [], []
    real_dw, real_conv = QC.int8_dw, QC.int8_conv

    def int8_dw(x, p):
        dw_calls.append(p.k)
        return real_dw(x, p)

    def int8_conv(x, p, act=None):
        if p.kind == "dw":
            silu_after.append(act)
        return real_conv(x, p, act)
    monkeypatch.setattr(QC, "int8_dw", int8_dw)
    monkeypatch.setattr(QC, "int8_conv", int8_conv)
    with torch.no_grad():
        model(x)
    assert routed == []
    if mode == "int8":
        assert len(dw_calls) == 16
        assert silu_after.count("silu") == 10 and silu_after.count(None) == 6
    else:
        assert dw_calls == []
