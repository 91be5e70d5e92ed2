"""P3 neck cluster (deploy layers 19-22): the port's plain version against the
JAX Pallas kernel in interpret mode, against the JAX f32 cluster and against
the port's own deploy layers. The CUDA kernel is held against the plain
version in tests/test_torch_gpu.py.

The JAX kernel computes in bf16, hence its own tests' tolerance (rtol 0.08,
atol 0.05, mean error < 0.01); against the f32 layers only summation order
differs (1e-4). Random folded weights make every bias nonzero.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.ops import neck_pallas as JN
from mafyolo_tpu_torch.ops import neck as N
from mafyolo_tpu_torch.ops._mma_pack import unpack_b
from tests.test_neck_pallas import _xla_cluster
from torch_common import port_model, port_specs, random_folded, to_jax

NAMES = ["maf-yolo-n", "maf-yolo-s"]


@pytest.fixture(scope="module")
def weights():
    out = {}
    for seed, name in enumerate(NAMES):
        folded = random_folded(name, 7, seed=30 + seed)
        out[name] = (jax_build_model(name, nc=7), folded, port_model(name, 7, folded))
    return out


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, (b, cfg.h, cfg.h, c)).astype(np.float32) for c in cfg.cins]


def _port(model, cfg, xs):
    nw = N.neck80_build(model.net, cfg)
    return [y.numpy() for y in N.neck80_forward(*map(torch.from_numpy, xs), nw)]


def _jax_kernel(jmodel, folded, h, xs, rows=0):
    cfg = JN.neck80_cfg(jmodel.specs, h)
    wts = JN.neck80_weights(to_jax(folded)["params"]["net"], jmodel.specs, cfg)
    out = JN.neck80_forward(*map(jnp.asarray, xs), wts, cfg, interpret=True, rows=rows)
    return [np.asarray(y, np.float32) for y in out]


def _assert_kernel_tolerance(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0.08, atol=0.05)
        assert np.abs(g - w).mean() < 0.01


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("h", [16, 32])
def test_plain_neck_matches_jax_kernel(weights, name, h):
    jmodel, folded, model = weights[name]
    cfg = N.neck80_cfg(model.specs, h)
    xs = _inputs(cfg, 2, h)
    got = _port(model, cfg, xs)
    assert [g.shape[-1] for g in got] == [cfg.c20, cfg.c22]
    _assert_kernel_tolerance(got, _jax_kernel(jmodel, folded, h, xs))


@pytest.mark.parametrize("name", NAMES)
def test_plain_neck_matches_jax_cluster(weights, name):
    jmodel, folded, model = weights[name]
    cfg = N.neck80_cfg(model.specs, 16)
    xs = _inputs(cfg, 2, 5)
    want = _xla_cluster(jmodel, to_jax(folded), *map(jnp.asarray, xs))
    for g, w in zip(_port(model, cfg, xs), want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)
        assert np.asarray(w).std() > 1e-2


def test_plain_neck_nonzero_bias_halo():
    """Biases U(0.2, 1) on every conv of layers 20 and 22: out-of-image
    pixels must act as zero padding at every DW of both RepHDWs. The JAX
    kernel runs 4 bands at h = 32 (rows=8), so every inter-band halo is
    exercised on its side."""
    folded = random_folded("maf-yolo-n", 7, seed=7)
    rng = np.random.default_rng(7)
    p = folded["params"]["net"]
    for layer in ("layer20", "layer22"):
        for path in (("cv_in",), ("cv_out",), ("m0", "expand"), ("m0", "dw", "fused"),
                     ("m0", "project")):
            node = p[layer]
            for k in path:
                node = node[k]
            node["conv"]["bias"] = rng.uniform(0.2, 1.0, node["conv"]["bias"].shape) \
                .astype(np.float32)
    jmodel, model = jax_build_model("maf-yolo-n", nc=7), port_model("maf-yolo-n", 7, folded)
    cfg = N.neck80_cfg(model.specs, 32)
    xs = _inputs(cfg, 1, 8)
    got = _port(model, cfg, xs)
    _assert_kernel_tolerance(got, _jax_kernel(jmodel, folded, 32, xs, rows=8))
    want = _xla_cluster(jmodel, to_jax(folded), *map(jnp.asarray, xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
def test_neck_cfg_matches_jax(name):
    specs = port_specs(name, 80)
    jspecs = jax_build_model(name, nc=80).specs
    assert N.neck80_supported(specs) and JN.neck80_supported(jspecs)
    cfg, jcfg = N.neck80_cfg(specs, 80), JN.neck80_cfg(jspecs, 80)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    assert not N.neck80_supported(specs[:22])


def test_neck_layout_dispatch_and_model_layers(weights):
    """The packed buffer has its layout's length; a CPU tensor takes the
    plain version and counts no launch; the plain version equals the deploy
    model's own Concat -> layer20 -> Concat -> layer22; a wrong source shape
    raises."""
    _, _, model = weights["maf-yolo-s"]
    cfg = N.neck80_cfg(model.specs, 16)
    nw = N.neck80_build(model.net, cfg)
    assert nw.flat.numel() == sum(int(np.prod(s)) for _, s in N._layout(cfg))
    xs = [torch.from_numpy(x) for x in _inputs(cfg, 2, 3)]
    before = N.neck80_forward.launches
    y20, y22 = N.neck80_forward(*xs, nw, torch.bfloat16)
    assert y20.dtype == y22.dtype == torch.bfloat16
    assert N.neck80_forward.launches == before
    with torch.no_grad():
        cat = torch.cat([x.permute(0, 3, 1, 2) for x in xs], 1)
        w20 = model.net.layer20(cat)
        w22 = model.net.layer22(torch.cat([w20, xs[2].permute(0, 3, 1, 2)], 1))
    p20, p22 = N.neck80_plain(*xs, nw)
    torch.testing.assert_close(p20, w20.permute(0, 2, 3, 1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(p22, w22.permute(0, 2, 3, 1), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="want sources"):
        N.neck80_forward(xs[1], xs[0], xs[2], nw)
    with pytest.raises(ValueError, match="f32 or bf16"):
        N.neck80_forward(*(x.double() for x in xs), nw)


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
def test_mma_pack_round_trips(name):
    """The bf16 tensor-core pack holds, GEMM by GEMM in launch order, exactly
    the bf16 cast of the f32 1x1 weights (every width of N, S and M is a
    multiple of 16, so nothing is padded, and every output width one of 32,
    so the columns are interleaved); the DW weights stay f32 only."""
    model = port_model(name, 7, random_folded(name, 7, seed=9))
    cfg = N.neck80_cfg(model.specs, 16)
    nw = N.neck80_build(model.net, cfg)
    parts, names = N._unpack(nw), N._mma_names(cfg)
    assert len(names) == 2 * (2 + 2 * cfg.d1) and N._mma_ok(cfg)
    assert all(n.split(".")[1].startswith("w") and "wdw" not in n for n in names)
    off = 0
    for n in names:
        k, cols = parts[n].shape
        assert k % 16 == 0 and cols % 32 == 0
        got = unpack_b(nw.mma[off:off + k * cols], k, cols, interleave=True)
        assert torch.equal(got, parts[n].bfloat16())
        off += k * cols
    assert off == nw.mma.numel() and nw.mma.dtype == torch.bfloat16
