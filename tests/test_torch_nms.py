"""Port compaction, greedy NMS and fused decode+NMS, held against the JAX
package. The CUDA NMS kernel is held against its plain version in
tests/test_torch_gpu.py.

Keep sets must be exactly equal; boxes and scores agree within 1e-4 (the DFL
softmax expectation is summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.ops.boxes import box_iou_pairwise as jax_iou
from mafyolo_tpu.ops.boxes import xywh2xyxy as jax_xywh2xyxy
from mafyolo_tpu.ops.compaction import compact_mask_indices as jax_compact
from mafyolo_tpu.ops.nms import _greedy_nms_mask
from mafyolo_tpu.ops.nms import fused_decode_nms as jax_fused
from mafyolo_tpu_torch.ops import greedy_nms as G
from mafyolo_tpu_torch.ops.boxes import box_iou_pairwise, xywh2xyxy
from mafyolo_tpu_torch.ops.compaction import compact_mask_indices
from mafyolo_tpu_torch.ops.nms import fused_decode_nms
from mafyolo_tpu_torch.utils import nms_cases as NC


def _boxes(seed, b, m, spread=640.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (b, m, 2)).astype(np.float32)
    wh = rng.uniform(10, 80, (b, m, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1), rng.uniform(0, 1, (b, m)) > 0.15


def _jax_keep(boxes, valid, thr):
    bj = jnp.asarray(boxes)
    iou = jax.vmap(lambda x: jax_iou(x, x))(bj)
    return np.asarray(jax.vmap(lambda i, v: _greedy_nms_mask(i, v, thr))(
        iou, jnp.asarray(valid)))


def test_boxes_match_jax():
    boxes, _ = _boxes(1, 1, 64)
    xywh = np.concatenate([boxes[0, :, :2], boxes[0, :, 2:] - boxes[0, :, :2]], -1)
    np.testing.assert_array_equal(xywh2xyxy(torch.from_numpy(xywh)).numpy(),
                                  np.asarray(jax_xywh2xyxy(jnp.asarray(xywh))))
    b = torch.from_numpy(boxes[0])
    np.testing.assert_array_equal(box_iou_pairwise(b, b).numpy(),
                                  np.asarray(jax_iou(jnp.asarray(boxes[0]),
                                                     jnp.asarray(boxes[0]))))


@pytest.mark.parametrize("m", [256, 512])
def test_plain_greedy_mask_matches_jax(m):
    boxes, valid = _boxes(m, 3, m, spread=300.0)   # dense: long chains
    got = G.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5).numpy()
    want = _jax_keep(boxes, valid, 0.5)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum() and not got[~valid].any()


@pytest.mark.parametrize("n,k,p", [(300, 64, 0.1), (2000, 512, 0.2),
                                   (2000, 512, 0.5)])
def test_compaction_matches_jax(n, k, p):
    mask = np.random.default_rng(n + k).uniform(0, 1, (2, n)) < p
    idx, count = compact_mask_indices(torch.from_numpy(mask), k)
    for i in range(2):
        j_idx, j_count = jax_compact(jnp.asarray(mask[i]), k)
        assert int(count[i]) == int(j_count)
        c = min(int(j_count), k)
        np.testing.assert_array_equal(idx[i, :c].numpy(), np.asarray(j_idx)[:c])
        assert idx[i].max() < n


def _head_outs(seed, nc=7, img=128, hot=0.02, ties=False):
    """Per-level NHWC (feat, cls, reg) with a controlled share of
    above-threshold scores and clustered DFL boxes."""
    rng = np.random.default_rng(seed)
    outs = []
    for s in (8, 16, 32):
        h = w = img // s
        cls = rng.uniform(0, 0.02, (2, h, w, nc))
        hot_mask = rng.uniform(0, 1, (2, h, w, nc)) < hot
        scores = rng.uniform(0.05, 0.95, cls.shape)
        if ties:
            scores = np.round(scores * 4) / 4 + 0.05   # five distinct values
        cls = np.where(hot_mask, scores, cls).astype(np.float32)
        reg = rng.normal(0, 2, (2, h, w, 68)).astype(np.float32)
        feat = np.zeros((2, h, w, 4), np.float32)
        outs.append((feat, cls, reg))
    return outs


@pytest.mark.parametrize("case,kw", [
    ("fast", dict(hot=0.03)),
    ("overflow", dict(hot=0.35)),      # > compact_k pairs: the dense path
    ("ties", dict(hot=0.05, ties=True)),
])
def test_fused_decode_nms_matches_jax(case, kw):
    outs = _head_outs(7, **kw)
    n_pairs = sum((o[1] > 0.03).sum(axis=(1, 2, 3)) for o in outs)   # per image
    assert (n_pairs.max() > 512) == (case == "overflow")
    nms_kw = dict(strides=(8, 16, 32), conf_thres=0.03, iou_thres=0.65,
                  max_det=100)
    want = jax_fused([tuple(jnp.asarray(t) for t in o) for o in outs], **nms_kw)
    before = G.greedy_nms.launches
    got = fused_decode_nms([tuple(torch.from_numpy(t) for t in o) for o in outs],
                           **nms_kw)
    assert G.greedy_nms.launches == before   # CPU: the plain version only
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    v = np.asarray(want["valid"])
    assert v.sum(1).min() > 10
    np.testing.assert_array_equal(got["classes"].numpy()[v],
                                  np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["scores"].numpy()[v],
                               np.asarray(want["scores"])[v], atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy()[v],
                               np.asarray(want["boxes"])[v], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case,kw", [
    ("fast", dict(hot=0.03)),
    ("overflow", dict(hot=0.35)),
    ("ties", dict(hot=0.05, ties=True)),
])
def test_fused_decode_nms_single_label_matches_jax(case, kw):
    """multi_label=False (the inference CLI's NMS): each anchor keeps its
    best class only: equal to JAX's fused_decode_nms(multi_label=False) on
    both paths, and other than the multi_label=True result."""
    outs = _head_outs(8, **kw)
    nms_kw = dict(strides=(8, 16, 32), conf_thres=0.03, iou_thres=0.65, max_det=100,
                  multi_label=False)
    want = jax_fused([tuple(jnp.asarray(t) for t in o) for o in outs], **nms_kw)
    got = fused_decode_nms([tuple(torch.from_numpy(t) for t in o) for o in outs], **nms_kw)
    v = np.asarray(want["valid"])
    assert v.sum(1).min() > 10
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["classes"].numpy()[v], np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["scores"].numpy()[v], np.asarray(want["scores"])[v],
                               atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v],
                               atol=1e-4, rtol=1e-5)
    both = fused_decode_nms([tuple(torch.from_numpy(t) for t in o) for o in outs],
                            **{**nms_kw, "multi_label": True})
    assert not torch.equal(both["scores"], got["scores"])


@pytest.mark.slow
def test_plain_greedy_mask_matches_pallas_kernel():
    from mafyolo_tpu.ops.pallas_nms import pallas_greedy_nms
    boxes, valid = _boxes(5, 2, 256)
    want = np.asarray(pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(valid),
                                        0.5, interpret=True))
    got = G.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the CUDA kernel's formulation (suppression bit matrix, then a walk in
# chunks of 64) in plain tensors, held to the sequential plain version


@pytest.mark.parametrize("m", NC.SIZES)
def test_bitmatrix_formulation_matches_plain(m):
    boxes, valid = NC.random_boxes(m, 2 if m > 512 else 4, m)
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    want = G.greedy_nms_plain(bt, vt, 0.65)
    got = G.greedy_nms_bitmatrix_plain(bt, vt, 0.65)
    assert torch.equal(got, want)
    assert not got[~vt].any() and (m < 256 or 0 < got.sum() < vt.sum())


@pytest.mark.parametrize("case", NC.CORNER_CASES)
def test_bitmatrix_formulation_corner_cases(case):
    boxes, valid, thr = NC.corner_case(case)
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    want = G.greedy_nms_plain(bt, vt, thr)
    assert torch.equal(G.greedy_nms_bitmatrix_plain(bt, vt, thr), want)
    assert NC.expected(case, want.numpy())


@pytest.mark.parametrize("case", NC.CORNER_CASES)
def test_plain_greedy_mask_corner_cases_match_jax(case):
    boxes, valid, thr = NC.corner_case(case)
    got = G.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    np.testing.assert_array_equal(got, _jax_keep(boxes, valid, thr))


@pytest.mark.parametrize("m,words", [(1, 64), (64, 64), (65, 256), (512, 4096), (2000, 65536)])
def test_matrix_words(m, words):
    """Scratch of the bit matrix: ceil(M/64) words a row, rows padded to a
    multiple of 64 (32 KB an image at M = 512, 512 KB at M = 2000)."""
    assert G.matrix_words(m) == words


@pytest.mark.parametrize("a,nc,multi_label,agnostic", [(300, 5, True, False),
                                                       (2100, 3, True, False),
                                                       (700, 4, False, False),
                                                       (700, 4, True, True)])
def test_batched_nms_matches_jax(a, nc, multi_label, agnostic):
    """ops/nms.py:batched_nms (quantized_predict_fn's NMS) against the JAX
    one on [B, A, 5+nc] decodes with clustered boxes: two-stage top-M (M =
    min(2000, A nc) pairs; A = 2100 takes more than one greedy block), keep
    sets exact, boxes and scores within 1e-4."""
    from mafyolo_tpu.ops.nms import batched_nms as jax_batched
    from mafyolo_tpu_torch.ops.nms import batched_nms
    rng = np.random.default_rng(a + nc)
    ctr = rng.uniform(40, 600, (2, a // 20, 1, 2))
    xy = (ctr + rng.normal(0, 6, (2, a // 20, 20, 2))).reshape(2, a, 2)
    wh = rng.uniform(20, 90, (2, a, 2))
    cls = rng.uniform(0, 1, (2, a, nc)) ** 4
    pred = np.concatenate([xy, wh, np.ones((2, a, 1)), cls], -1).astype(np.float32)
    kw = dict(conf_thres=0.03, iou_thres=0.65, max_det=300, multi_label=multi_label,
              agnostic=agnostic)
    want = {k: np.asarray(v) for k, v in jax_batched(jnp.asarray(pred), **kw).items()}
    got = {k: v.numpy() for k, v in batched_nms(torch.from_numpy(pred), **kw).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum(1).min() > 20
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("case,kw", [
    ("no_dfl", dict(use_dfl=False)),
    ("agnostic", dict(agnostic=True)),
    ("no_dfl_agnostic_overflow", dict(use_dfl=False, agnostic=True)),
])
def test_fused_decode_nms_options_match_jax(case, kw):
    """use_dfl=False (4 raw ltrb channels in grid units, reg_max 0) and
    agnostic=True (no class offset: boxes of other classes suppress too)
    against JAX's fused_decode_nms with the same options, the last case
    through the dense path."""
    hot = 0.35 if "overflow" in case else 0.05
    outs = _head_outs(9, hot=hot)
    if not kw.get("use_dfl", True):
        rng = np.random.default_rng(10)
        outs = [(f, c, rng.uniform(0.3, 4.0, r.shape[:-1] + (4,)).astype(np.float32))
                for f, c, r in outs]
    nms_kw = dict(strides=(8, 16, 32), conf_thres=0.03, iou_thres=0.65, max_det=100,
                  reg_max=0 if not kw.get("use_dfl", True) else 16, **kw)
    want = jax_fused([tuple(jnp.asarray(t) for t in o) for o in outs], **nms_kw)
    got = fused_decode_nms([tuple(torch.from_numpy(t) for t in o) for o in outs], **nms_kw)
    v = np.asarray(want["valid"])
    assert v.sum(1).min() > 10
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["classes"].numpy()[v], np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["scores"].numpy()[v], np.asarray(want["scores"])[v],
                               atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v],
                               atol=1e-4, rtol=1e-5)
    if kw.get("agnostic"):
        offset = fused_decode_nms([tuple(torch.from_numpy(t) for t in o) for o in outs],
                                  **{**nms_kw, "agnostic": False})
        assert not torch.equal(offset["boxes"], got["boxes"])
