"""Front-end (deploy layers 0-2, and layers 0-1 at depth 0): the port's plain
version against the JAX Pallas kernel in interpret mode (fuse_l2 on and
off) and against the JAX f32 layers, and the port's routing against JAX's.
The CUDA kernel is held against the plain version in tests/test_torch_gpu.py.

Random folded weights make every bias nonzero, so out-of-image rows and
columns must act as zero padding at each layer boundary (the round-3 halo
leak, tests/test_frontend_pallas.py:81-89); 256 rows span several tiles.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.ops import frontend_pallas as JF
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.ops import frontend as F
from mafyolo_tpu_torch.ops._mma_pack import pad16, unpack_b
from tests.test_frontend_pallas import _xla_frontend
from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict, random_folded_variables
from torch_common import port_model, random_folded, to_jax, u8_images

HW = [(64, 64), (128, 64), (256, 64)]


@pytest.fixture(scope="module")
def n_weights():
    folded = random_folded("maf-yolo-n", 7, seed=21)
    fw = F.frontend_build(port_model("maf-yolo-n", 7, folded).net)
    return jax_build_model("maf-yolo-n", nc=7), folded, fw


def _biases_nonzero(folded):
    l2 = folded["params"]["net"]["layer2"]
    return all(np.all(b != 0) for b in (
        folded["params"]["net"]["layer0"]["fused"]["conv"]["bias"],
        l2["cv_in"]["conv"]["bias"], l2["m0"]["expand"]["conv"]["bias"],
        l2["m0"]["dw"]["fused"]["conv"]["bias"]))


@pytest.mark.parametrize("hw", HW)
def test_plain_frontend_matches_jax_kernel(n_weights, hw):
    """Tolerance of the JAX kernel's own tests: it computes in bf16."""
    jmodel, folded, fw = n_weights
    assert _biases_nonzero(folded)
    imgs = u8_images(hw[0], (2, *hw, 3))
    cfg, wts = JF.frontend_build(jmodel.specs, folded, *hw)
    xp = jnp.asarray(JF.pack_s2d_np(imgs, cfg))
    want = np.asarray(JF.frontend_forward(xp, tuple(wts), cfg, interpret=True)
                      [:, :, :cfg.wb, :], np.float32)
    got = F.frontend_forward(torch.from_numpy(imgs), fw).numpy()
    assert got.shape == want.shape == (2, hw[0] // 4, hw[1] // 4, 48)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    assert np.abs(got - want).mean() < 0.01


@pytest.mark.parametrize("hw", [(64, 64), (256, 64)])
def test_plain_frontend_matches_jax_layers(n_weights, hw):
    """Against the JAX f32 layers 0-2: only summation order differs."""
    jmodel, folded, fw = n_weights
    imgs = u8_images(7, (2, *hw, 3))
    want = np.asarray(_xla_frontend(jmodel, to_jax(folded), jnp.asarray(imgs), upto=2))
    got = F.frontend_forward(torch.from_numpy(imgs), fw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_frontend_dispatch_and_layout(n_weights):
    """CPU tensors take the plain version and count no launch; the packed
    buffer has the length of its layout; S (depth 2) packs too."""
    _, _, fw = n_weights
    n = sum(int(np.prod(s)) for _, s in F._layout(fw.cfg))
    assert fw.flat.numel() == n and fw.cfg.dims() == (24, 48, 24, 72, 1, 48)
    before = F.frontend_forward.launches
    y = F.frontend_forward(torch.from_numpy(u8_images(0, (1, 64, 64, 3))), fw,
                           torch.bfloat16)
    assert y.dtype == torch.bfloat16 and F.frontend_forward.launches == before
    s_fw = F.frontend_build(port_model("maf-yolo-s", 7,
                                       random_folded("maf-yolo-s", 7)).net)
    assert s_fw.cfg.dims() == (32, 64, 32, 96, 2, 64)


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
def test_mma_pack_round_trips(name):
    """The bf16 tensor-core pack holds exactly the bf16 cast of the f32
    parts: layer 0's 27 tap rows as one block, layer 1's rows one 16-padded
    block per tap, cv_in's columns as
    [a | b] halves padded to 16, cv_out's rows one padded block per CSP
    part; every pad row and column is zero."""
    fw = F.frontend_build(port_model(name, 7, random_folded(name, 7, seed=5)).net)
    c0, c1, c_, mid, depth, c2 = fw.cfg.dims()
    parts = F._unpack(fw)
    c0p, csp = pad16(c0), pad16(c_)
    shapes = [("w0", 27, c0), ("w1", 9 * c0p, c1), ("win", c1, 2 * csp)]
    for i in range(depth):
        shapes += [(f"wexp{i}", c_, mid), (f"wproj{i}", mid, c_)]
    shapes.append(("wout", (2 + depth) * csp, c2))
    got, off = {}, 0
    for key, k, n in shapes:
        size = pad16(k) * pad16(n)
        got[key] = unpack_b(fw.mma[off:off + size], k, n).float()
        off += size
    assert off == fw.mma.numel() and fw.mma.dtype == torch.bfloat16

    def same(block, want):       # the block is `want` in bf16, zero beyond it
        k, n = want.shape
        ref = torch.zeros_like(block)
        ref[:k, :n] = want.bfloat16().float()
        assert torch.equal(block, ref)

    same(got["w0"], parts["w0"].reshape(27, c0))
    for t in range(9):
        same(got["w1"][t * c0p:(t + 1) * c0p], parts["w1"].reshape(9, c0, c1)[t])
    same(got["win"][:, :csp], parts["win"][:, :c_])
    same(got["win"][:, csp:2 * csp], parts["win"][:, c_:])
    assert not got["win"][:, 2 * csp:].any()
    for i in range(depth):
        same(got[f"wexp{i}"], parts[f"wexp{i}"])
        same(got[f"wproj{i}"], parts[f"wproj{i}"])
    for j in range(2 + depth):
        same(got["wout"][j * csp:(j + 1) * csp], parts["wout"][j * c_:(j + 1) * c_])
    assert not got["wout"][(2 + depth) * csp:].any()
    assert any(v.std() > 1e-3 for v in got.values())


# ---------------------------------------------------------------------------
# The layers-0-1 mode (depth 0): the YOLOv6 office graphs N and M, whose
# layer 2 is a RepBlock or a BepC3 (JAX frontend_forward with fuse_l2=False).


def _office(name):
    from mafyolo_tpu_torch.models.office import office_config_graph
    graph = office_config_graph(name)
    specs = build_model(graph, nc=7).specs
    folded = random_folded_variables(specs, seed=23)
    model = build_model(graph, nc=7, deploy=True)
    model.load_state_dict(folded_to_state_dict(folded))
    return graph, folded, model


@pytest.fixture(scope="module")
def office_n():
    graph, folded, model = _office("yolov6n-office")
    return graph, folded, F.frontend_build(model.net, fuse_l2=False)


@pytest.mark.parametrize("hw", [(64, 64), (256, 64)])
def test_layers01_plain_matches_jax_kernel(office_n, hw):
    """The plain version at depth 0 against the JAX kernel with fuse_l2=False
    in interpret mode, nonzero biases (relu(b0) outside the image must not
    reach layer 1's dy=-1 taps); 256 rows span several of its bands. The
    JAX kernel's own tolerance: it computes in bf16."""
    graph, folded, fw = office_n
    net = folded["params"]["net"]
    assert all(np.all(net[f"layer{i}"]["fused"]["conv"]["bias"] != 0) for i in (0, 1))
    imgs = u8_images(hw[0] + 1, (2, *hw, 3))
    jmodel = jax_build_model(graph, nc=7)
    cfg, wts = JF.frontend_build(jmodel.specs, folded, *hw, fuse_l2=False)
    xp = jnp.asarray(JF.pack_s2d_np(imgs, cfg))
    want = np.asarray(JF.frontend_forward(xp, tuple(wts), cfg, interpret=True)
                      [:, :, :cfg.wb, :], np.float32)
    got = F.frontend_forward(torch.from_numpy(imgs), fw).numpy()
    assert got.shape == want.shape == (2, hw[0] // 4, hw[1] // 4, 32)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    assert np.abs(got - want).mean() < 0.01 and want.std() > 0.05
    # and against the JAX f32 layers 0-1: only summation order differs
    want32 = np.asarray(_xla_frontend(jmodel, to_jax(folded), jnp.asarray(imgs), upto=1))
    np.testing.assert_allclose(got, want32, atol=1e-4, rtol=1e-4)


def test_layers01_layout_pack_and_model_route(office_n):
    """Depth 0 packs w0, b0, w1, b1 alone (the f32 buffer and the bf16 MMA
    pack), the plain version returns layer 1's c1 channels, and the deploy
    model run from them (skip_until=1) gives the model's own output."""
    graph, folded, fw = office_n
    assert fw.cfg.dims() == (16, 32, 0, 0, 0, 0) and fw.cfg.cout == 32
    assert [n for n, _ in F._layout(fw.cfg)] == ["w0", "b0", "w1", "b1"]
    assert fw.flat.numel() == 27 * 16 + 16 + 9 * 16 * 32 + 32
    parts = F._unpack(fw)
    assert fw.mma.numel() == pad16(27) * 16 + 9 * 16 * 32
    w0 = unpack_b(fw.mma[:32 * 16], 27, 16).float()
    assert torch.equal(w0[:27], parts["w0"].reshape(27, 16).bfloat16().float())
    assert not w0[27:].any()
    w1 = unpack_b(fw.mma[32 * 16:], 9 * 16, 32).float()
    assert torch.equal(w1, parts["w1"].reshape(9 * 16, 32).bfloat16().float())
    _, _, model = _office("yolov6n-office")
    imgs = torch.from_numpy(u8_images(4, (2, 64, 64, 3)))
    with torch.no_grad():
        got = model(F.frontend_forward(imgs, fw), skip_until=1)
        want = model(imgs.flip(-1).float() / 255.0, skip_until=-1)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    m_fw = F.frontend_build(_office("yolov6m-office")[2].net, fuse_l2=False)
    assert m_fw.cfg.dims() == (48, 96, 0, 0, 0, 0)


def _yaml_rephdw_k5():
    """A reference-format graph whose layer 2 is a RepHDW of kernel 5."""
    from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
    g = copy.deepcopy(MODEL_ZOO["maf-yolo-n"])
    g["backbone"][2][3][3] = 5
    return g


@pytest.mark.parametrize("which", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m", "yolov6n-office",
                                   "yolov6m-office", "yolov6l-office", "rephdw-k5"])
def test_skip_until_equals_jax(which):
    """The port's routing (frontend_supported, frontend_l2_supported,
    frontend_skip_until) equals JAX's: 2 for the MAF graphs, 1 for office N
    and M and a graph whose layer 2 is a RepHDW of k = 5, -1 for office L
    (layer 0 a ConvWrapper)."""
    from mafyolo_tpu_torch.models.office import office_config_graph
    graph = (_yaml_rephdw_k5() if which == "rephdw-k5" else
             office_config_graph(which) if "office" in which else which)
    port, jax_model = build_model(graph, nc=7), jax_build_model(graph, nc=7)
    got = (F.frontend_supported(port.specs, port.save), F.frontend_l2_supported(port.specs),
           F.frontend_skip_until(port.specs, port.save))
    want = (JF.frontend_supported(jax_model.specs, jax_model.save),
            JF.frontend_l2_supported(jax_model.specs),
            JF.frontend_skip_until(jax_model.specs, jax_model.save))
    assert got == want
    assert got[2] == {"yolov6n-office": 1, "yolov6m-office": 1, "yolov6l-office": -1,
                      "rephdw-k5": 1}.get(which, 2)
