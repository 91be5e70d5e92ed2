"""MAF-YOLO-S's INT8 flow (core/quant.py) against the JAX package's
(mafyolo_tpu/core/quant.py), f32 on the CPU at 64 px: the max-calibrated
amax tree on JAX's paths (S's RepHDW rows repeat twice, which gives paths
N has not, m1/...), and the int8 heads and decode on the port's tree. The
JAX INT8_INFER flag is set and restored around its use. Weights and images
come from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.core import quant as JQ
from mafyolo_tpu.models import blocks as JB
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.detect import decode_eval as jax_decode_eval
from mafyolo_tpu_torch.core import quant as Q
from mafyolo_tpu_torch.models.detect import decode_eval
from torch_common import random_folded, to_jax, tree_leaves

NC, IMG, NAME = 5, 64, "maf-yolo-s"


@pytest.fixture(scope="module")
def s_calibrated():
    folded = random_folded(NAME, NC, seed=0)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8) for _ in range(2)]
    want = JQ.ptq_calibrate(NAME, NC, to_jax(folded), batches, max_batches=2)
    got = Q.ptq_calibrate(NAME, NC, folded, batches, max_batches=2, device="cpu")
    return folded, batches, jax.tree.map(np.asarray, want), got


def test_s_max_tree_matches_jax(s_calibrated):
    """Every amax leaf on JAX's paths (convs, the pool_q of SPPF and the
    MPReps, the neck's up_q), values at rtol 1e-6; the second bottleneck of
    each RepHDW row (m1) is there; init_quant_tree gives the same paths."""
    folded, _, want, got = s_calibrated
    w, g = dict(tree_leaves(want)), dict(tree_leaves(got))
    assert g.keys() == w.keys()
    assert any("/m1/" in k for k in g) and not any("/m2/" in k for k in g)
    assert sum(k.endswith("/pool_q/act_amax") for k in g) == 4
    assert sum(k.endswith("/up_q/act_amax") for k in g) == 2
    assert all(v.shape == () and v.dtype == np.float32 and v > 0 for v in g.values())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    zero = dict(tree_leaves(Q.init_quant_tree(NAME, NC, folded)))
    assert zero.keys() == w.keys() and not any(v for v in zero.values())


def test_s_int8_decode_matches_jax(s_calibrated):
    """S's int8 decode against JAX's INT8 graph on the port's tree, f32:
    mean |cls| < 1e-3, as N's (tests/test_torch_quant.py). Measured: mean
    5.1e-5, max 4.1e-4. The integer convs are exact on both sides, but
    inside jit XLA computes JAX's weight scale max|w| / 127.0 as a multiply
    by 1/127 (a division by a constant), where the port divides (its
    contract, ops/quant_conv.py): about a quarter of layer 0's outputs
    differ by an ulp, and roundings downstream flip. The int8 predict runs."""
    folded, batches, _, got = s_calibrated
    xf = (batches[0][..., ::-1].astype(np.float32) / np.float32(255)).copy()
    jm = jax_build_model(NAME, nc=NC, deploy=True, quant=True)
    jv = {"params": to_jax(folded)["params"], "quant": to_jax(got)}
    JB.INT8_INFER = True
    try:
        # the variables are arguments: XLA turns a division by a constant
        # into a reciprocal multiply
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jv, jnp.asarray(xf))
    finally:
        JB.INT8_INFER = False
    with torch.no_grad():
        heads = Q.quant_model(NAME, NC, folded, got, mode="int8", device="cpu")(
            torch.from_numpy(xf))
    s = (8, 16, 32)
    d = np.abs(decode_eval(heads, s).numpy()[..., 5:]
               - np.asarray(jax_decode_eval(want, strides=s))[..., 5:])
    assert d.mean() < 1e-3, (d.mean(), d.max())
    out = Q.int8_predict_fn(NAME, NC, folded, got, conf_thres=0.001, device="cpu")(batches[0])
    assert out["boxes"].shape == (2, 300, 4)
