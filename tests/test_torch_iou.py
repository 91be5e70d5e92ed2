"""The IoU-loss family (mafyolo_tpu_torch/ops/boxes.py) and the detection
loss under it (models/losses/loss.py), held against the JAX package on the
same inputs (numpy, from a seed), f32 on the CPU.

iou_loss for every iou_type and both box formats, and wiou_loss (Wise-IoU
v3: the per-element loss and the running mean, with and without a mask):
values and the gradient of a weighted sum with respect to the predicted
boxes within rtol 1e-5 / atol 1e-6, on random boxes with identical,
disjoint and zero-size pairs among them (NaN where JAX's is, at the same
elements). detection_loss under each iou_type, with a loss_weight, with
use_dfl=False (4 raw ltrb channels, reg_max 0), and Wise-IoU's mean
threaded through two calls (the second call reads the first's):
components rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models.losses import detection_loss as jax_detection_loss
from mafyolo_tpu.ops.boxes import iou_loss as jax_iou_loss
from mafyolo_tpu.ops.boxes import wiou_loss as jax_wiou_loss
from mafyolo_tpu_torch.models.losses import detection_loss
from mafyolo_tpu_torch.ops.boxes import iou_loss, wiou_loss

NC, IMG, STRIDES = 5, 64, (8, 16, 32)
HW = [(IMG // s, IMG // s) for s in STRIDES]
IOU_TYPES = ("giou", "diou", "ciou", "siou", "iou")


def _boxes(seed: int, n: int = 96):
    """Aligned xyxy pairs [n, 4]: random, then identical (rows 0-7),
    disjoint (8-15) and zero-size second boxes (16-23)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 50, (n, 2))
    b = a + rng.uniform(-15, 15, (n, 2))
    box1 = np.concatenate([a, a + rng.uniform(1, 30, (n, 2))], -1)
    box2 = np.concatenate([b, b + rng.uniform(1, 30, (n, 2))], -1)
    box2[:8] = box1[:8]
    box2[8:16] = box1[8:16] + 100.0
    box2[16:24, 2:] = box2[16:24, :2]
    return box1.astype(np.float32), box2.astype(np.float32)


def _xywh(b):
    return np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], -1)


@pytest.mark.parametrize("box_format", ["xyxy", "xywh"])
@pytest.mark.parametrize("iou_type", IOU_TYPES)
def test_iou_loss_values_and_grads_match_jax(iou_type, box_format):
    box1, box2 = _boxes(1)
    if box_format == "xywh":
        box1, box2 = _xywh(box1), _xywh(box2)
    w = np.random.default_rng(2).uniform(0.5, 1.5, box1.shape[0]).astype(np.float32)

    def jf(b1):
        return (jax_iou_loss(b1, jnp.asarray(box2), iou_type, box_format) * w).sum()
    want = jax_iou_loss(jnp.asarray(box1), jnp.asarray(box2), iou_type, box_format)
    want_g = jax.grad(jf)(jnp.asarray(box1))
    b1 = torch.from_numpy(box1).requires_grad_()
    got = iou_loss(b1, torch.from_numpy(box2), iou_type, box_format)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b1.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    # CIoU's alpha is 0 / 0 on identical boxes (iou rounds to 1 in f32), in
    # the reference too: NaN in both packages, at the same rows
    assert np.isfinite(np.asarray(want)[8:]).all()


def test_unknown_iou_type_raises_as_jax():
    box1, box2 = _boxes(1, 4)
    with pytest.raises(ValueError, match="unknown iou_type"):
        jax_iou_loss(jnp.asarray(box1), jnp.asarray(box2), "wiou")
    with pytest.raises(ValueError, match="unknown iou_type"):
        iou_loss(torch.from_numpy(box1), torch.from_numpy(box2), "wiou")


@pytest.mark.parametrize("masked", [False, True])
def test_wiou_loss_values_mean_and_grads_match_jax(masked):
    box1, box2 = _boxes(3)
    box2[16:24] = box1[16:24] + 1.0           # Wise-IoU has no eps: no zero-size box
    rng = np.random.default_rng(4)
    mask = (rng.uniform(size=box1.shape[0]) < 0.6).astype(np.float32) if masked else None
    w = rng.uniform(0.5, 1.5, box1.shape[0]).astype(np.float32)
    mean0 = 0.8

    def jf(b1):
        loss, _ = jax_wiou_loss(b1, jnp.asarray(box2), jnp.float32(mean0),
                                mask=None if mask is None else jnp.asarray(mask))
        return (loss * w).sum()
    want, want_mean = jax_wiou_loss(jnp.asarray(box1), jnp.asarray(box2), jnp.float32(mean0),
                                    mask=None if mask is None else jnp.asarray(mask))
    want_g = jax.grad(jf)(jnp.asarray(box1))
    b1 = torch.from_numpy(box1).requires_grad_()
    got, got_mean = wiou_loss(b1, torch.from_numpy(box2), torch.tensor(mean0),
                              mask=None if mask is None else torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got_mean), float(want_mean), rtol=1e-6)
    np.testing.assert_allclose(b1.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    assert got_mean.dtype == torch.float32 and float(got_mean) != mean0


def _targets():
    t = np.zeros((2, 6, 5), np.float32)
    t[..., 0] = -1
    t[0, :3] = [[1, .27, .23, .3, .3], [3, .6, .55, .5, .4], [0, .8, .2, .2, .25]]
    t[1, :2] = [[4, .5, .5, .9, .8], [2, .3, .7, .25, .2]]
    return t


def _head_outs(seed, reg_ch=4 * 17):
    """Per-level (feat, cls sigmoid, reg) NHWC, numpy. With 4 reg channels
    (use_dfl=False) the reg values are ltrb distances in grid units."""
    rng = np.random.default_rng(seed)
    outs = []
    for h, w in HW:
        feat = rng.normal(0, 1, (2, h, w, 4)).astype(np.float32)
        cls = rng.uniform(0.01, 0.99, (2, h, w, NC)).astype(np.float32)
        reg = (rng.normal(0, 2, (2, h, w, reg_ch)) if reg_ch > 4
               else rng.uniform(0.2, 3.0, (2, h, w, 4))).astype(np.float32)
        outs.append((feat, cls, reg))
    return outs


def _both(outs, t, **kw):
    want = jax_detection_loss([tuple(map(jnp.asarray, o)) for o in outs], jnp.asarray(t), **kw)
    kw = {k: (torch.tensor(float(v)) if k == "wiou_mean" and v is not None else v)
          for k, v in kw.items()}
    got = detection_loss([tuple(map(torch.from_numpy, o)) for o in outs],
                         torch.from_numpy(t), **kw)
    return got, want


def _check(got, want):
    (total, comps), (w_total, w_comps) = got, want
    assert comps.keys() == w_comps.keys()
    for k in w_comps:
        np.testing.assert_allclose(float(comps[k]), float(w_comps[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(w_total), rtol=1e-5)
    assert float(comps["iou"]) > 0


@pytest.mark.parametrize("use_atss", [True, False])
@pytest.mark.parametrize("iou_type", IOU_TYPES + ("wiou",))
def test_detection_loss_per_iou_type_matches_jax(iou_type, use_atss):
    kw = dict(use_atss=use_atss, num_classes=NC, img_size=IMG, strides=STRIDES,
              iou_type=iou_type)
    _check(*_both(_head_outs(5), _targets(), **kw))


def test_detection_loss_weight_and_no_dfl_match_jax():
    lw = {"class": 0.7, "iou": 3.0, "dfl": 0.25}
    kw = dict(use_atss=False, num_classes=NC, img_size=IMG, strides=STRIDES)
    _check(*_both(_head_outs(6), _targets(), loss_weight=lw, **kw))
    got, want = _both(_head_outs(7, reg_ch=4), _targets(), use_dfl=False, reg_max=0,
                      iou_type="ciou", **kw)
    _check(got, want)
    assert float(got[1]["dfl"]) == 0.0


def test_wiou_mean_threads_through_two_calls_as_jax():
    """The first call starts from the state's 1.0; the second reads the
    first's new mean, in both packages."""
    kw = dict(use_atss=False, num_classes=NC, img_size=IMG, strides=STRIDES, iou_type="wiou")
    got1, want1 = _both(_head_outs(8), _targets(), wiou_mean=1.0, **kw)
    _check(got1, want1)
    j_mean, p_mean = want1[1]["wiou_mean"], got1[1]["wiou_mean"]
    want2 = jax_detection_loss([tuple(map(jnp.asarray, o)) for o in _head_outs(9)],
                               jnp.asarray(_targets()), wiou_mean=j_mean, **kw)
    got2 = detection_loss([tuple(map(torch.from_numpy, o)) for o in _head_outs(9)],
                          torch.from_numpy(_targets()), wiou_mean=p_mean, **kw)
    _check(got2, want2)
    assert float(p_mean) != 1.0 and float(got2[1]["wiou_mean"]) != float(p_mean)
