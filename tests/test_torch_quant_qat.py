"""The port's histogram calibration and QAT step (core/quant.py) against
the JAX package's (mafyolo_tpu/core/quant.py), MAF-YOLO-N at 64 px (nc 5),
f32 on the CPU, on the same folded weights and uint8 batches."""
import jax
import numpy as np

from mafyolo_tpu.core import quant as JQ
from mafyolo_tpu_torch.core import quant as Q
from torch_common import random_folded, to_jax, tree_leaves

NC, IMG = 5, 64


def _batches():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8) for _ in range(2)]


def test_percentile_tree_matches_jax():
    """Two-pass percentile calibration (256 bins, 99th percentile): the
    trees hold only act_amax leaves, on JAX's 88 paths, within 1e-5
    relative of JAX's; every amax is at most its max-calibrated one and
    some are clipped."""
    folded, batches = random_folded("maf-yolo-n", NC, seed=0), _batches()
    kw = dict(max_batches=2, method="percentile", percentile=99.0, num_bins=256)
    want = dict(tree_leaves(jax.tree.map(
        np.asarray, JQ.ptq_calibrate("maf-yolo-n", NC, to_jax(folded), batches, **kw))))
    got = dict(tree_leaves(Q.ptq_calibrate("maf-yolo-n", NC, folded, batches,
                                           device="cpu", **kw)))
    assert got.keys() == want.keys() and len(got) == 88
    assert all(k.endswith("/act_amax") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    maxes = dict(tree_leaves(Q.ptq_calibrate("maf-yolo-n", NC, folded, batches,
                                             max_batches=2, device="cpu")))
    assert all(got[k] <= maxes[k] for k in got)
    assert any(got[k] < maxes[k] for k in got)


class _OneBatch:
    """The loader protocol qat_finetune reads: set_epoch, then batches of
    (uint8 images, padded targets, shapes)."""

    def __init__(self, imgs, targets):
        self.batch = (imgs, targets, None)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        yield self.batch


def test_qat_step_matches_jax():
    """One QAT step (TAL loss, fake-quant STE, the JAX update with lr 0.01
    so that the step shows) from the same weights and amax tree: every
    parameter within 2e-4 of its leaf's magnitude (floored at 1e-2 of the
    tree's), as the train-step tests hold the train step, and every
    parameter's change within 5e-3 of the largest change of its leaf (plus
    two ulps of the leaf's magnitude: p' - p is known to that ulp)."""
    folded, batches = random_folded("maf-yolo-n", NC, seed=0), _batches()
    quant = Q.ptq_calibrate("maf-yolo-n", NC, folded, batches, max_batches=2, device="cpu")
    t = np.zeros((2, 6, 5), np.float32)
    t[..., 0] = -1
    t[0, :3] = [[1, .3, .3, .3, .35], [3, .6, .55, .5, .4], [0, .8, .2, .2, .25]]
    t[1, :2] = [[2, .5, .5, .8, .7], [4, .3, .7, .25, .2]]
    loader = _OneBatch(batches[0], t)
    kw = dict(img_size=IMG, epochs=1, lr=0.01)
    want = dict(tree_leaves(jax.tree.map(np.asarray, JQ.qat_finetune(
        "maf-yolo-n", NC, to_jax(folded), to_jax(quant), loader, **kw))))
    got = dict(tree_leaves(Q.qat_finetune("maf-yolo-n", NC, folded, quant, loader,
                                          device="cpu", **kw)))
    before = dict(tree_leaves(folded))
    assert got.keys() == want.keys() == before.keys()
    top = max(np.abs(w).max() for w in want.values())
    moved = 0
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-2 * top)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-4 * scale, err_msg=k)
        dw, dg = w - before[k], got[k] - before[k]
        ulp = np.spacing(np.abs(before[k]).max().astype(np.float32))
        np.testing.assert_allclose(dg, dw, rtol=0, atol=5e-3 * np.abs(dw).max() + 2 * ulp,
                                   err_msg=k)
        moved += bool(np.abs(dw).max() > 0)
    assert moved > len(want) // 2, moved
