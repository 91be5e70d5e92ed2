"""The slice end to end: port Evaler.predict (uint8 -> front-end -> deploy
model -> fused decode + NMS) against the JAX Evaler on the same folded
weights and uint8 batch, MAF-YOLO-N at 128 px, f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mafyolo_tpu.core.evaler import Evaler as JaxEvaler
from mafyolo_tpu_torch.core.evaler import Evaler
from torch_common import random_folded, to_jax, u8_images


def _folded_with_detections(seed):
    """Random weights, cls_pred biases shifted so that each image has a few
    hundred (anchor, class) pairs above conf 0.03 at 128 px (fast path)."""
    folded = random_folded("maf-yolo-n", 7, seed=seed)
    net = folded["params"]["net"]
    for i in (31, 32, 33):
        net[f"layer{i}"]["cls_pred"]["bias"] = net[f"layer{i}"]["cls_pred"]["bias"] - 3.3
    return folded


def test_predict_matches_jax_evaler():
    folded = _folded_with_detections(0)
    imgs = u8_images(9, (2, 128, 128, 3))
    ev = Evaler(half=False)
    ev.init_model("maf-yolo-n", folded, nc=7, folded=True)
    assert ev.fe_skip == 2
    got = {k: v.numpy() for k, v in ev.predict(imgs).items()}

    jev = JaxEvaler({}, half=False)
    jev.init_model("maf-yolo-n", to_jax(folded), 7, folded=True)
    want = jax.tree.map(np.asarray, jev._predict(jnp.asarray(imgs)))

    n = want["valid"].sum(1)
    np.testing.assert_array_equal(got["valid"].sum(1), n)
    assert n.min() >= 5
    for i in range(2):
        k = n[i]
        # match each JAX detection to a port detection of the same class
        for box, score, cls in zip(want["boxes"][i, :k], want["scores"][i, :k],
                                   want["classes"][i, :k]):
            cand = np.flatnonzero((got["classes"][i, :k] == cls)
                                  & (np.abs(got["scores"][i, :k] - score) <= 1e-3))
            err = np.abs(got["boxes"][i, cand] - box).max(-1) if len(cand) else []
            assert len(cand) and np.min(err) <= 1e-2, (i, box, score, cls)


def test_train_form_raises_and_scale_coords():
    ev = Evaler(half=False)
    # train-form weights are folded first; a tree without them cannot be
    with pytest.raises(KeyError, match="params"):
        ev.init_model("maf-yolo-n", {}, nc=7, folded=False)
    boxes = np.array([[10.0, 20.0, 630.0, 600.0]])
    # 640x640 letterbox of a 320x480 (h, w) image: gain 4/3, pad (0, 106.67)
    out = ev.scale_coords((640, 640), boxes.copy(), (320, 480))
    np.testing.assert_allclose(out, [[7.5, 0.0, 472.5, 320.0]], atol=1e-6)

