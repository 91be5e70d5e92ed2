"""The slices end to end against the JAX Evaler on the same folded weights
and uint8 batch, f32 on the CPU: port Evaler.predict (uint8 -> front-end ->
deploy model -> fused decode + NMS), MAF-YOLO-N at 128 px and at 126x94 (the
route without the front-end kernel); and MAF-YOLO-S through the stem route
(uint8 -> stem -> skip_stem deploy model -> fused decode + NMS) at 128 px."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.core.evaler import Evaler as JaxEvaler
from mafyolo_tpu_torch.core import evaler as evaler_mod
from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.ops.nms import fused_decode_nms
from mafyolo_tpu_torch.ops.stem import stem_apply, stem_build
from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict
from torch_common import random_folded, to_jax, u8_images


def _folded_with_detections(seed, name="maf-yolo-n"):
    """Random weights, cls_pred biases shifted so that each image has a few
    hundred (anchor, class) pairs above conf 0.03 at 128 px (fast path)."""
    folded = random_folded(name, 7, seed=seed)
    net = folded["params"]["net"]
    for i in (31, 32, 33):
        net[f"layer{i}"]["cls_pred"]["bias"] = net[f"layer{i}"]["cls_pred"]["bias"] - 3.3
    return folded


def _assert_matches(got, want):
    """Every JAX detection has a port detection of the same class, score
    within 1e-3 and box within 1e-2 px; the counts per image are equal."""
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


def _jax_predict(name, folded, imgs):
    jev = JaxEvaler({}, half=False)
    jev.init_model(name, to_jax(folded), 7, folded=True)
    return jax.tree.map(np.asarray, jev._predict(jnp.asarray(imgs)))


def _both_predict(folded, imgs):
    ev = Evaler(half=False, device="cpu")
    ev.init_model("maf-yolo-n", folded, nc=7, folded=True)
    assert ev.fe_skip == 2
    got = {k: v.numpy() for k, v in ev.predict(imgs).items()}
    return ev, got, _jax_predict("maf-yolo-n", folded, imgs)


def test_predict_matches_jax_evaler():
    _, got, want = _both_predict(_folded_with_detections(0), u8_images(9, (2, 128, 128, 3)))
    _assert_matches(got, want)


def test_predict_routes_by_shape(monkeypatch):
    """126x94 is no multiple of 4, so the batch runs the model's own layers
    0-2, as in the JAX predict; the graph takes it (63/47 -> 32/24 -> 16/12
    -> 8/6 -> 4/3, every MPRep input even). With the front-end kernel
    raising, as it does on the card for such a shape, the batch still
    predicts, and a 128x128 batch reaches the kernel."""
    ev, got, want = _both_predict(_folded_with_detections(1), u8_images(4, (2, 126, 94, 3)))
    _assert_matches(got, want)

    def refuse(imgs, *a, **k):
        raise ValueError("front-end kernel called")

    monkeypatch.setattr(evaler_mod, "frontend_forward", refuse)
    again = ev.predict(u8_images(4, (2, 126, 94, 3)))
    np.testing.assert_array_equal(again["valid"].numpy(), got["valid"])
    with pytest.raises(ValueError, match="front-end kernel called"):
        ev.predict(u8_images(5, (2, 128, 128, 3)))


def test_s_stem_route_matches_jax_evaler():
    """MAF-YOLO-S: stem_apply -> fused_decode_nms, what pallas_stem_apply
    feeds, against the JAX Evaler's full deploy model."""
    folded = _folded_with_detections(2, "maf-yolo-s")
    imgs = u8_images(6, (2, 128, 128, 3))
    model = build_model("maf-yolo-s", nc=7, deploy=True, skip_stem=True)
    model.load_state_dict(folded_to_state_dict(folded))
    with torch.no_grad():
        outs = stem_apply(model.eval(), stem_build(model.net), torch.from_numpy(imgs))
    got = {k: v.numpy() for k, v in fused_decode_nms(outs).items()}
    _assert_matches(got, _jax_predict("maf-yolo-s", folded, imgs))


def test_train_form_raises_and_scale_coords():
    ev = Evaler(half=False, device="cpu")
    # train-form weights are folded first; a tree without them cannot be
    with pytest.raises(KeyError, match="params"):
        ev.init_model("maf-yolo-n", {}, nc=7, folded=False)
    boxes = np.array([[10.0, 20.0, 630.0, 600.0]])
    # 640x640 letterbox of a 320x480 (h, w) image: gain 4/3, pad (0, 106.67)
    out = ev.scale_coords((640, 640), boxes.copy(), (320, 480))
    np.testing.assert_allclose(out, [[7.5, 0.0, 472.5, 320.0]], atol=1e-6)

