"""Port deploy model and detect decode, held against the JAX deploy model on
the same random folded weights (every leaf nonzero, cls_pred/reg_pred
included). f32 on the CPU: the only difference is summation order, hence
atol 1e-4 / rtol 1e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.detect import decode_eval as jax_decode_eval
from mafyolo_tpu_torch.models.detect import decode_eval
from torch_common import port_model, random_folded, to_jax


@pytest.mark.parametrize("name,img", [("maf-yolo-n", 64), ("maf-yolo-n", 128),
                                      ("maf-yolo-s", 64)])
def test_deploy_model_matches_jax(name, img):
    nc = 7
    folded = random_folded(name, nc, seed=11)
    x = np.random.default_rng(2).uniform(0, 1, (2, img, img, 3)).astype(np.float32)
    want = jax_build_model(name, nc=nc, deploy=True).apply(
        to_jax(folded), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_model(name, nc, folded)(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g_level, w_level in zip(got, want):
        for g, w in zip(g_level, w_level):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=1e-4, rtol=1e-3)
    # the head outputs are not constant (a vacuous comparison otherwise)
    assert float(np.asarray(want[0][1]).std()) > 1e-3
    ref = np.asarray(jax_decode_eval(want, strides=(8, 16, 32)))
    dec = decode_eval(got, strides=(8, 16, 32)).numpy()
    np.testing.assert_allclose(dec, ref, atol=1e-3, rtol=1e-4)


def test_skip_until_takes_layer2_output():
    """skip_until=2: the caller's layer-2 output replaces layers 0-2."""
    nc = 7
    folded = random_folded("maf-yolo-n", nc, seed=5)
    full = port_model("maf-yolo-n", nc, folded)
    skip = port_model("maf-yolo-n", nc, folded, skip_until=2)
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        y = x.permute(0, 3, 1, 2)
        for i in range(3):
            y = getattr(full.net, f"layer{i}")(y)
        got = skip(y.permute(0, 2, 3, 1))
        want = full(x)
    for g_level, w_level in zip(got, want):
        for g, w in zip(g_level, w_level):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
