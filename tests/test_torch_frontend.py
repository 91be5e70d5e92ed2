"""Front-end (deploy layers 0-2): the port's plain version against the JAX
Pallas kernel in interpret mode and against the JAX f32 layers. The CUDA
kernel is held against the plain version in tests/test_torch_gpu.py.

Random folded weights make every bias nonzero, so out-of-image rows and
columns must act as zero padding at each layer boundary (the round-3 halo
leak, tests/test_frontend_pallas.py:81-89); 256 rows span several tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.ops import frontend_pallas as JF
from mafyolo_tpu_torch.ops import frontend as F
from tests.test_frontend_pallas import _xla_frontend
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

