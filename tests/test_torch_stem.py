"""Stem conv (deploy layer 0): the port's plain version against the JAX Pallas
kernel in interpret mode, and `stem_apply` on a skip_stem deploy model
against the JAX full deploy model. The CUDA kernel is held against the plain
version in tests/test_torch_gpu.py.

Both sides compute in f32; only summation order differs (1e-4). Random
folded weights make every bias nonzero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.ops import stem_pallas as JS
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.ops import stem as S
from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict
from torch_common import port_model, port_specs, random_folded, to_jax, u8_images


@pytest.mark.parametrize("name,shape", [("maf-yolo-n", (2, 32, 48)),
                                        ("maf-yolo-n", (1, 16, 16)),
                                        ("maf-yolo-s", (2, 32, 48))])
def test_plain_stem_matches_jax_kernel(name, shape):
    """Every output pixel, the rolled-and-masked row 0 and column 0 included;
    H/2 is a multiple of 8, so the JAX grid writes every row."""
    folded = random_folded(name, 7, seed=shape[2])
    sw = S.stem_build(port_model(name, 7, folded).net)
    imgs = u8_images(shape[1], (*shape, 3))
    k, bias = JS.stem_params_from_folded(folded)
    want = np.asarray(JS.planar_to_nhwc(JS.stem_conv_s2(
        jnp.asarray(imgs), jnp.asarray(k), jnp.asarray(bias), dtype=jnp.float32,
        interpret=True)))
    got = S.stem_conv_s2(torch.from_numpy(imgs), sw).numpy()
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, sw.cout)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert (want > 0).mean() > 0.2


@pytest.mark.parametrize("img", [64, 128])
def test_stem_apply_matches_jax_deploy_model(img):
    """What pallas_stem_apply replaces: the full deploy model on flip/255."""
    folded = random_folded("maf-yolo-s", 7, seed=img)
    model = build_model("maf-yolo-s", nc=7, deploy=True, skip_stem=True)
    model.load_state_dict(folded_to_state_dict(folded))
    model.eval()
    assert model.net.skip_until == 0
    imgs = u8_images(img, (2, img, img, 3))
    x = imgs[..., ::-1].astype(np.float32) / 255.0
    want = jax_build_model("maf-yolo-s", nc=7, deploy=True).apply(
        to_jax(folded), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = S.stem_apply(model, S.stem_build(model.net), torch.from_numpy(imgs))
    for g_level, w_level in zip(got, want):
        for g, w in zip(g_level, w_level):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3)
    assert float(np.asarray(want[0][1]).std()) > 1e-3


def test_stem_supported_dispatch_and_errors():
    """stem_supported equals JAX's for N/S/M; a CPU tensor takes the plain
    version and counts no launch; odd sizes and a model without skip_stem
    raise."""
    for name in ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m"):
        assert S.stem_supported(port_specs(name, 80)) \
            == JS.stem_supported(jax_build_model(name, nc=80).specs) is True
    specs = port_specs("maf-yolo-n", 80)
    assert not S.stem_supported(specs[1:])
    model = port_model("maf-yolo-n", 7, random_folded("maf-yolo-n", 7))
    sw = S.stem_build(model.net)
    assert sw.cout == 24 and sw.flat.numel() == 28 * 24
    before = S.stem_conv_s2.launches
    y = S.stem_conv_s2(torch.from_numpy(u8_images(0, (1, 32, 64, 3))), sw, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 16, 32, 24)
    assert S.stem_conv_s2.launches == before
    with pytest.raises(ValueError, match="even"):
        S.stem_conv_s2(torch.from_numpy(u8_images(0, (1, 33, 64, 3))), sw)
    with pytest.raises(ValueError, match="uint8"):
        S.stem_conv_s2(torch.zeros(1, 32, 32, 3), sw)
    with pytest.raises(ValueError, match="skip_stem"):
        S.stem_apply(model, sw, torch.from_numpy(u8_images(0, (1, 32, 32, 3))))
