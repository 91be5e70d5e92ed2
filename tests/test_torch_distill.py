"""The distillation loss (mafyolo_tpu_torch/models/losses/distill.py), held
against the JAX package on the same inputs (numpy, from a seed), f32 on the
CPU: each distillation term (class KL with a temperature, DFL KL, the
channel-wise feature KL) and distill_detection_loss at epoch_num 0, mid and
max (the cosine decay), with and without the feature term, under ATSS and
TAL: values rtol 1e-5, and the gradient of the total with respect to the
student's maps rtol 1e-4, atol 1e-6 of the map's largest gradient (the
class gradients reach 13, where f32 rounding is 1e-6). As in JAX, the
distillation loss knows no Wise-IoU: iou_type 'wiou' raises ValueError in
both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models.losses import distill as J
from mafyolo_tpu_torch.models.losses import distill as D

NC, IMG, STRIDES, MAX_EPOCH = 5, 64, (8, 16, 32), 300
HW = [(IMG // s, IMG // s) for s in STRIDES]


def _outs(seed):
    """Per-level (feat, cls sigmoid, reg logits) NHWC, numpy."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (2, h, w, 6)).astype(np.float32),
             rng.uniform(0.01, 0.99, (2, h, w, NC)).astype(np.float32),
             rng.normal(0, 2, (2, h, w, 68)).astype(np.float32)) for h, w in HW]


def _targets():
    t = np.zeros((2, 6, 5), np.float32)
    t[..., 0] = -1
    t[0, :3] = [[1, .27, .23, .3, .3], [3, .6, .55, .5, .4], [0, .8, .2, .2, .25]]
    t[1, :2] = [[4, .5, .5, .9, .8], [2, .3, .7, .25, .2]]
    return t


def test_distill_terms_match_jax():
    s, t = _outs(1), _outs(2)
    for i in (1, 2):
        ls = np.concatenate([o[i].reshape(2, -1, o[i].shape[-1]) for o in s], 1)
        lt = np.concatenate([o[i].reshape(2, -1, o[i].shape[-1]) for o in t], 1)
        if i == 1:
            want = J.distill_loss_cls(jnp.asarray(ls), jnp.asarray(lt), 20.0)
            got = D.distill_loss_cls(torch.from_numpy(ls), torch.from_numpy(lt), 20.0)
        else:
            want = J.distill_loss_dfl(jnp.asarray(ls), jnp.asarray(lt), 20.0)
            got = D.distill_loss_dfl(torch.from_numpy(ls), torch.from_numpy(lt), 20.0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert float(got) > 0
    for temp in (1.0, 4.0):
        want = J.distill_loss_cw([jnp.asarray(o[0]) for o in s], [jnp.asarray(o[0]) for o in t],
                                 temp)
        got = D.distill_loss_cw([torch.from_numpy(o[0]) for o in s],
                                [torch.from_numpy(o[0]) for o in t], temp)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("use_atss", [True, False])
@pytest.mark.parametrize("distill_feat", [False, True])
@pytest.mark.parametrize("epoch_num", [0, MAX_EPOCH // 2 + 7, MAX_EPOCH])
def test_distill_detection_loss_matches_jax(epoch_num, distill_feat, use_atss):
    s, t, tg = _outs(3), _outs(4), _targets()
    kw = dict(epoch_num=epoch_num, max_epoch=MAX_EPOCH, use_atss=use_atss, num_classes=NC,
              img_size=IMG, strides=STRIDES, distill_feat=distill_feat)

    def jf(outs):
        return J.distill_detection_loss(outs, [tuple(map(jnp.asarray, o)) for o in t],
                                        jnp.asarray(tg), **{**kw, "epoch_num":
                                                            jnp.float32(epoch_num)})
    (w_total, w_comps), w_grads = jax.value_and_grad(jf, has_aux=True)(
        [tuple(map(jnp.asarray, o)) for o in s])
    ours = [tuple(torch.from_numpy(a).requires_grad_() for a in o) for o in s]
    total, comps = D.distill_detection_loss(
        ours, [tuple(map(torch.from_numpy, o)) for o in t], torch.from_numpy(tg), **kw)
    total.backward()
    assert comps.keys() == w_comps.keys()
    for k in w_comps:
        np.testing.assert_allclose(float(comps[k]), float(w_comps[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(w_total), rtol=1e-5)
    assert (float(comps["cwd"]) > 0) == distill_feat
    for o, wo in zip(ours, w_grads):
        for a, wa in zip(o, wo):
            if a.grad is None:        # feat without the feature term
                assert not distill_feat and not np.asarray(wa).any()
                continue
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(wa), rtol=1e-4,
                                       atol=1e-6 * np.abs(np.asarray(wa)).max())


def test_distill_decay_moves_the_distill_terms_only():
    s, t, tg = _outs(5), _outs(6), _targets()
    kw = dict(max_epoch=MAX_EPOCH, use_atss=False, num_classes=NC, img_size=IMG,
              strides=STRIDES, distill_feat=True)
    args = ([tuple(map(torch.from_numpy, o)) for o in s],
            [tuple(map(torch.from_numpy, o)) for o in t], torch.from_numpy(tg))
    first = D.distill_detection_loss(*args, epoch_num=0, **kw)[1]
    last = D.distill_detection_loss(*args, epoch_num=MAX_EPOCH, **kw)[1]
    assert float(first["iou"]) == float(last["iou"])
    np.testing.assert_allclose(float(last["cwd"]), 0.01 * float(first["cwd"]), rtol=1e-5)
    assert float(last["cls"]) < float(first["cls"])


def test_distill_with_wiou_raises_as_jax():
    s, t, tg = _outs(7), _outs(8), _targets()
    kw = dict(epoch_num=0, max_epoch=MAX_EPOCH, use_atss=False, num_classes=NC,
              img_size=IMG, strides=STRIDES, iou_type="wiou")
    with pytest.raises(ValueError, match="unknown iou_type"):
        J.distill_detection_loss([tuple(map(jnp.asarray, o)) for o in s],
                                 [tuple(map(jnp.asarray, o)) for o in t], jnp.asarray(tg), **kw)
    with pytest.raises(ValueError, match="unknown iou_type"):
        D.distill_detection_loss([tuple(map(torch.from_numpy, o)) for o in s],
                                 [tuple(map(torch.from_numpy, o)) for o in t],
                                 torch.from_numpy(tg), **kw)
