"""Assigners, the detection loss and the param groups, held against the JAX
package on the same inputs (numpy, from a seed), f32 on the CPU.

Assigners: labels and fg_mask exactly equal, target boxes and scores within
1e-5 (the same arithmetic; only the order of a few sums differs), with
cases built so that ATSS distances and TAL metrics tie: lax.top_k takes the
lower index first, which the port's stable sort reproduces. Loss
components rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TINY_GRAPH
from mafyolo_tpu.assigners import atss_assign as jax_atss
from mafyolo_tpu.assigners import tal_assign as jax_tal
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.detect import generate_anchors_train as jax_anchors
from mafyolo_tpu.models.losses import detection_loss as jax_detection_loss
from mafyolo_tpu.ops.boxes import iou_loss as jax_iou_loss
from mafyolo_tpu.solver.build import group_of as jax_group_of
from mafyolo_tpu_torch.assigners import atss_assign, tal_assign
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.detect import bbox2dist, generate_anchors_train
from mafyolo_tpu_torch.models.losses import detection_loss
from mafyolo_tpu_torch.ops.boxes import iou_loss
from mafyolo_tpu_torch.solver.build import (GROUP_BIAS, GROUP_BNW, GROUP_WEIGHT,
                                            jax_path, param_groups)

NC, IMG, STRIDES = 5, 64, (8, 16, 32)
HW = [(IMG // s, IMG // s) for s in STRIDES]


def _targets(tie: bool):
    """[2, 6, 5] padded targets (cls, cx, cy, w, h normalized; pad cls -1).
    tie: the first gt is centred at (16, 16) px, between the stride-8 anchor
    centres 12 and 20, so four anchors of that level are equally near."""
    t = np.zeros((2, 6, 5), np.float32)
    t[..., 0] = -1
    t[0, :3] = [[1, .25, .25, .3, .3], [3, .6, .55, .5, .4], [0, .8, .2, .2, .25]]
    t[1, :2] = [[4, .5, .5, .9, .8], [2, .3, .7, .25, .2]]
    if not tie:
        t[0, 0, 1:3] = [.27, .23]
    return t


def _preds(seed, tie: bool):
    """pd_scores [2,A,NC] and pd_bboxes [2,A,4] image-scale xyxy. tie: every
    anchor predicts the same box and score, so TAL's metrics tie."""
    rng = np.random.default_rng(seed)
    anchors, points, _, _ = jax_anchors(HW, STRIDES)
    a = points.shape[0]
    if tie:
        scores = np.full((2, a, NC), 0.5, np.float32)
        boxes = np.broadcast_to(np.array([8, 8, 40, 40], np.float32), (2, a, 4)).copy()
        return scores, boxes
    scores = rng.uniform(0.01, 0.99, (2, a, NC)).astype(np.float32)
    ltrb = rng.uniform(2, 24, (2, a, 4)).astype(np.float32)
    p = np.asarray(points)
    boxes = np.concatenate([p - ltrb[..., :2], p + ltrb[..., 2:]], -1).astype(np.float32)
    return scores, boxes


def _gt(t):
    from mafyolo_tpu.ops.boxes import xywh2xyxy
    gb = np.asarray(xywh2xyxy(jnp.asarray(t[..., 1:] * IMG)))
    mask = (gb.sum(-1, keepdims=True) > 0).astype(np.float32)
    return t[..., :1], gb * mask, mask


def _check_assign(got, want):
    labels, boxes, scores, fg = (x.numpy() for x in got)
    w_labels, w_boxes, w_scores, w_fg = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(fg, w_fg)
    np.testing.assert_array_equal(np.where(fg, labels, -7), np.where(w_fg, w_labels, -7))
    np.testing.assert_array_equal(labels, w_labels)
    np.testing.assert_allclose(boxes, w_boxes, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, w_scores, atol=1e-5, rtol=1e-5)
    assert fg.sum() > 0


def test_train_anchors_and_bbox2dist_match_jax():
    got = generate_anchors_train(HW, STRIDES)
    want = jax_anchors(HW, STRIDES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    from mafyolo_tpu.models.detect import bbox2dist as jax_bbox2dist
    _, boxes = _preds(0, False)
    pts = np.asarray(want[1]) / np.asarray(want[3])
    np.testing.assert_allclose(bbox2dist(torch.from_numpy(pts), torch.from_numpy(boxes / 8), 16),
                               np.asarray(jax_bbox2dist(pts, boxes / 8, 16)), atol=1e-6)


@pytest.mark.parametrize("tie", [False, True])
def test_atss_matches_jax(tie):
    anchors, _, counts, _ = jax_anchors(HW, STRIDES)
    labels, gb, mask = _gt(_targets(tie))
    _, pd = _preds(1, False)
    want = jax_atss(anchors, tuple(counts), jnp.asarray(labels), jnp.asarray(gb),
                    jnp.asarray(mask), jnp.asarray(pd), topk=9, num_classes=NC)
    t = torch.from_numpy
    got = atss_assign(t(np.array(anchors)), counts, t(labels), t(gb), t(mask), t(pd),
                      topk=9, num_classes=NC)
    _check_assign(got, want)


@pytest.mark.parametrize("tie", [False, True])
def test_tal_matches_jax(tie):
    _, points, _, _ = jax_anchors(HW, STRIDES)
    labels, gb, mask = _gt(_targets(tie))
    scores, pd = _preds(2, tie)
    want = jax_tal(jnp.asarray(scores), jnp.asarray(pd), points, jnp.asarray(labels),
                   jnp.asarray(gb), jnp.asarray(mask), topk=13, num_classes=NC)
    t = torch.from_numpy
    got = tal_assign(t(scores), t(pd), t(np.array(points)), t(labels), t(gb), t(mask),
                     topk=13, num_classes=NC)
    _check_assign(got, want)


def _head_outs(seed):
    """Per-level (feat, cls sigmoid, reg logits) NHWC, numpy."""
    rng = np.random.default_rng(seed)
    outs = []
    for h, w in HW:
        feat = rng.normal(0, 1, (2, h, w, 4)).astype(np.float32)
        cls = rng.uniform(0.01, 0.99, (2, h, w, NC)).astype(np.float32)
        reg = rng.normal(0, 2, (2, h, w, 4 * 17)).astype(np.float32)
        outs.append((feat, cls, reg))
    return outs


@pytest.mark.parametrize("use_atss,empty", [(True, False), (False, False), (False, True)])
def test_detection_loss_matches_jax(use_atss, empty):
    outs = _head_outs(3)
    t = _targets(False)
    if empty:                     # all padding: target_scores_sum 0 divides by 1
        t[..., 0], t[..., 1:] = -1, 0
    kw = dict(use_atss=use_atss, num_classes=NC, img_size=IMG, strides=STRIDES)
    w_total, w_comps = jax_detection_loss([tuple(map(jnp.asarray, o)) for o in outs],
                                          jnp.asarray(t), **kw)
    total, comps = detection_loss([tuple(map(torch.from_numpy, o)) for o in outs],
                                  torch.from_numpy(t), **kw)
    for k in ("iou", "dfl", "cls"):
        np.testing.assert_allclose(float(comps[k]), float(w_comps[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(total), float(w_total), rtol=1e-5)
    assert np.isfinite(float(total)) and (float(comps["cls"]) > 0)
    if empty:
        assert float(comps["iou"]) == 0.0 and float(comps["dfl"]) == 0.0
    else:
        assert float(comps["iou"]) > 0 and float(comps["dfl"]) > 0


def test_giou_loss_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 50, (64, 2))
    b = rng.uniform(0, 50, (64, 2))
    box1 = np.concatenate([a, a + rng.uniform(0, 30, (64, 2))], -1).astype(np.float32)
    box2 = np.concatenate([b, b + rng.uniform(0, 30, (64, 2))], -1).astype(np.float32)
    box2[:4] = box1[:4]                                  # identical boxes
    box2[4:8, 2:] = box2[4:8, :2]                        # zero-size boxes
    np.testing.assert_allclose(
        iou_loss(torch.from_numpy(box1), torch.from_numpy(box2)).numpy(),
        np.asarray(jax_iou_loss(jnp.asarray(box1), jnp.asarray(box2), "giou")),
        rtol=1e-6, atol=1e-6)


def test_param_groups_match_jax_group_of():
    """Every torch parameter lands in the group the JAX solver gives its leaf;
    a BN weight is JAX `scale`, the BN-weight group, not the decayed one."""
    model = build_model(TINY_GRAPH, nc=NC)
    groups = param_groups(model)
    gid = {id(p): g for g, ps in enumerate(groups) for p in ps}
    assert sum(map(len, groups)) == len(list(model.parameters()))
    shapes = jax.eval_shape(lambda: jax_build_model(TINY_GRAPH, nc=NC).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = {tuple(str(k.key) for k in path): jax_group_of(path) for path, _ in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = {jax_path(n, p): gid[id(p)] for n, p in model.named_parameters()}
    assert got == want
    bn_weight = model.net.layer0.dense.bn.weight
    assert gid[id(bn_weight)] == GROUP_BNW
    assert gid[id(model.net.layer0.dense.conv.weight)] == GROUP_WEIGHT
    assert gid[id(model.net.layer0.dense.bn.bias)] == GROUP_BIAS
