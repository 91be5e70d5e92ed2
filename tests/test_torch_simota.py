"""The SimOTA path (models/blocks.py:Head_Simota, models/losses/simota.py,
models/detect.py:decode_simota_eval), held against the JAX package on the
same inputs (numpy, from a seed), f32 on the CPU.

Head_Simota in train mode on bridged weights: (cls, reg, obj) within 1e-5.
simota_loss: every component rtol 1e-5 and the gradients of the raw maps
rtol 1e-4 / atol 1e-6, on random maps and on a tie case: every anchor of a
level decodes to the same box with the same scores, so the costs of the
anchors inside both a gt and its center square tie exactly (the stable
argsort then takes the lowest index, as jnp.argsort does), and two gts
are the same box of the same class (the conflict goes to the first, as
jnp.argmin takes it); a different pick moves the L1 term, whose targets
hold each anchor's grid cell. There the L1 term meets exact zeros, where
the gradient of |x| is JAX's, 1 (ops/boxes.py:abs_). decode_simota_eval
within 1e-5. The Evaler's DFL decode raises on a Head_simota graph in
both packages."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TINY_GRAPH
from mafyolo_tpu.models.detect import decode_simota_eval as jax_decode_simota_eval
from mafyolo_tpu.models.losses.simota import simota_loss as jax_simota_loss
from mafyolo_tpu_torch.models.detect import decode_simota_eval
from mafyolo_tpu_torch.models.losses.simota import simota_loss

NC, IMG, STRIDES = 4, 64, (8, 16, 32)
HW = [(IMG // s, IMG // s) for s in STRIDES]

SIMOTA_GRAPH = copy.deepcopy(TINY_GRAPH)
SIMOTA_GRAPH["effidehead"] = [[3, 1, "Head_simota", [32, 0]], [4, 1, "Head_simota", [32, 0]],
                              [5, 1, "Head_simota", [32, 0]], [[6, 7, 8], 1, "Out", []]]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_head_simota_train_mode_matches_jax():
    """Head_Simota alone in train mode (batch statistics) on bridged random
    weights, a 2x16x16x24 input: (cls, reg, obj) within 1e-5; the init's
    cls and obj biases at the 1e-2 prior, reg's at 0, as flax's."""
    from flax.core import unfreeze

    from mafyolo_tpu.models.blocks import Head_Simota as JaxHead
    from mafyolo_tpu_torch.models.blocks import Head_Simota
    from mafyolo_tpu_torch.utils.bridge import (state_dict_to_train_variables,
                                                train_variables_to_state_dict)
    x = np.random.default_rng(5).normal(0, 1, (2, 16, 16, 24)).astype(np.float32)
    head = Head_Simota(24, 32, reg_max=0, nc=6)
    init = state_dict_to_train_variables({f"net.{k}": v for k, v in head.state_dict().items()})
    prior = -np.log(99.0)
    for name, bias in (("cls_pred", prior), ("obj_pred", prior), ("reg_pred", 0.0)):
        np.testing.assert_allclose(init["params"]["net"][name]["bias"], bias, rtol=1e-6)
    jhead = JaxHead(24, 32, reg_max=0, nc=6)
    j_init = unfreeze(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    assert {k: np.shape(v) for k, v in _leaves(j_init)} == \
        {k: np.shape(v) for k, v in _leaves({c: t["net"] for c, t in init.items()})}
    rng = np.random.default_rng(6)
    variables = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                             if a.ndim == 1 else rng.uniform(-0.3, 0.3, a.shape)
                             .astype(np.float32), j_init)
    head.load_state_dict({k[4:]: v for k, v in train_variables_to_state_dict(
        {c: {"net": t} for c, t in variables.items()}).items()})
    want, _ = jhead.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = head.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [g.shape[1] for g in got] == [6, 4, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def _targets():
    t = np.zeros((2, 6, 5), np.float32)
    t[..., 0] = -1
    t[0, :3] = [[1, .27, .23, .3, .3], [3, .6, .55, .5, .4], [0, .8, .2, .2, .25]]
    t[1, :2] = [[2, .5, .5, .9, .8], [1, .3, .7, .25, .2]]
    return t


def _random_outs(seed):
    """Per-level raw (cls, reg, obj) NHWC."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(-2, 1.5, (2, h, w, NC)).astype(np.float32),
             rng.normal(0, 0.7, (2, h, w, 4)).astype(np.float32),
             rng.normal(-1, 1.5, (2, h, w, 1)).astype(np.float32)) for h, w in HW]


def _tie_outs():
    """Every anchor of a level decodes to the box (cx, cy, w, h) = (24, 24,
    20, 20) px with the same cls and obj logits."""
    outs = []
    for (h, w), s in zip(HW, STRIDES):
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        reg = np.zeros((2, h, w, 4), np.float32)
        reg[..., 0] = 24.0 / s - gx
        reg[..., 1] = 24.0 / s - gy
        reg[..., 2:] = np.log(20.0 / s)
        cls = np.full((2, h, w, NC), -1.0, np.float32)
        cls[..., 2] = 0.5
        obj = np.full((2, h, w, 1), 0.2, np.float32)
        outs.append((cls, reg, obj))
    return outs


def _tie_targets():
    t = np.zeros((2, 4, 5), np.float32)
    t[..., 0] = -1
    t[:, :3] = [[2, .375, .375, .3, .3], [2, .375, .375, .3, .3], [1, .7, .6, .25, .3]]
    return t


@pytest.mark.parametrize("case", ["random", "tie"])
@pytest.mark.parametrize("iou_type", ["ciou", "giou"])
def test_simota_loss_matches_jax(case, iou_type):
    outs, t = (_random_outs(3), _targets()) if case == "random" else (_tie_outs(), _tie_targets())
    kw = dict(num_classes=NC, img_size=IMG, strides=STRIDES, iou_type=iou_type)

    def jf(o):
        return jax_simota_loss(o, jnp.asarray(t), **kw)
    (w_total, w_comps), w_grads = jax.value_and_grad(jf, has_aux=True)(
        [tuple(map(jnp.asarray, o)) for o in outs])
    ours = [tuple(torch.from_numpy(a).requires_grad_() for a in o) for o in outs]
    total, comps = simota_loss(ours, torch.from_numpy(t), **kw)
    total.backward()
    assert comps.keys() == w_comps.keys()
    for k in w_comps:
        np.testing.assert_allclose(float(comps[k]), float(w_comps[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(w_total), rtol=1e-5)
    assert float(comps["l1"]) > 0 and float(comps["iou"]) > 0
    for o, wo in zip(ours, w_grads):
        for a, wa in zip(o, wo):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(wa), rtol=1e-4, atol=1e-6)


def test_simota_tie_picks_the_first_index():
    """The tie case's picks: the duplicate gt's anchors all go to the first
    of the two (its L1 and IoU terms are the first gt's), and dynamic-k
    takes the lowest-index anchors among equal costs."""
    from mafyolo_tpu_torch.models.losses import simota as SL
    outs = [tuple(torch.from_numpy(a) for a in o) for o in _tie_outs()]
    decoded, _, shifts, stride_col = SL._decode_levels(outs, STRIDES)
    t = torch.from_numpy(_tie_targets())
    fg, gt, iou = SL._assign_one(
        decoded[0, :, :4], decoded[0, :, 4], decoded[0, :, 5:], t[0, :, 1:] * IMG,
        t[0, :, 0].long().clamp(0, NC - 1), (t[0, :, 1:].sum(-1) > 0) & (t[0, :, 0] >= 0),
        (shifts[0] + 0.5) * stride_col[0], stride_col[0, :, 0], num_classes=NC)
    assert fg.sum() > 1 and not (gt[fg] == 1).any() and (gt[fg] == 0).any()
    picked = fg.nonzero().flatten()
    level0 = picked[picked < HW[0][0] * HW[0][1]]
    assert len(level0) and torch.equal(level0, torch.sort(level0).values)


def test_decode_simota_eval_matches_jax():
    outs = _random_outs(4)
    want = jax_decode_simota_eval([tuple(map(jnp.asarray, o)) for o in outs], STRIDES)
    got = decode_simota_eval([tuple(map(torch.from_numpy, o)) for o in outs], STRIDES)
    assert got.shape == (2, sum(h * w for h, w in HW), 5 + NC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_evaler_decode_raises_on_a_simota_graph_as_jax():
    """The Evalers decode DFL heads only: on a Head_simota graph both raise
    TypeError in the DFL decode (a gap of the JAX package, which the
    Trainer's per-epoch eval meets; the port has no SimOTA eval route
    either)."""
    from mafyolo_tpu.core.evaler import Evaler as JaxEvaler
    from mafyolo_tpu.models import build_model as jax_build_model
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.utils.bridge import random_train_variables
    variables = random_train_variables(build_model(SIMOTA_GRAPH, nc=NC).specs, seed=1)
    jm = jax_build_model(SIMOTA_GRAPH, nc=NC)
    assert [(s.idx, s.kind, s.kwargs) for s in jm.specs] == \
        [(s.idx, s.kind, s.kwargs) for s in build_model(SIMOTA_GRAPH, nc=NC).specs]
    jev = JaxEvaler({"nc": NC}, img_size=IMG, half=False)
    jev.init_model(SIMOTA_GRAPH, variables, NC, folded=False)
    with pytest.raises(TypeError, match="reshape"):
        jev._predict(jnp.zeros((2, IMG, IMG, 3), jnp.uint8))
    ev = Evaler(half=False, device="cpu")
    ev.init_model(SIMOTA_GRAPH, variables, NC, folded=False)
    with pytest.raises(TypeError, match="reshape"):
        ev.predict(torch.zeros((2, IMG, IMG, 3), dtype=torch.uint8))
