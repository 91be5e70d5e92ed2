"""The learnable synthetic set (utils/sample.py:synth_set) and the overfit
tool (tools/overfit.py) on the CPU: TINY_GRAPH at 64 px, bs 4, f32 (the
Trainer takes f32 on the CPU), the tool's own calls as on the card."""
import os
import pickle

import numpy as np
import pytest

from helpers import COLORS, TINY_GRAPH
from mafyolo_tpu_torch.tools import overfit as OF
from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
from mafyolo_tpu_torch.utils.sample import (SYNTH_COLORS, SYNTH_VAL_RATIOS, synth_set,
                                            synth_val_sizes)

SIZES = [(64, 64), (48, 64), (64, 36), (97, 131)]


def _boxes_px(label, h, w):
    """(cls, x1, y1, bw, bh) in pixels of a normalized cls-xywh row."""
    c, cx, cy, bw, bh = (float(v) for v in label)
    bw_px, bh_px = round(bw * w), round(bh * h)
    return int(c), round(cx * w - bw_px / 2), round(cy * h - bh_px / 2), bw_px, bh_px


def test_set_is_seeded_and_holds_the_test_sets_shape():
    a, b, c = synth_set(3, SIZES), synth_set(3, SIZES), synth_set(4, SIZES)
    assert SYNTH_COLORS == tuple(COLORS)
    for x, y in zip(a["images"] + a["labels"], b["images"] + b["labels"]):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a["images"], c["images"]))
    for img, lb, (h, w) in zip(a["images"], a["labels"], SIZES):
        assert img.shape == (h, w, 3) and img.dtype == np.uint8
        assert lb.dtype == np.float32 and 1 <= len(lb) <= 4
        assert set(lb[:, 0].astype(int)) <= {0, 1, 2}
        assert ((lb[:, 3] >= 1 / 8 - 1 / w) & (lb[:, 3] < 1 / 3)).all()
        assert ((lb[:, 4] >= 1 / 8 - 1 / h) & (lb[:, 4] < 1 / 3)).all()


def test_every_label_is_its_drawn_rectangle():
    """Without the noise: a label's box, less the boxes drawn after it, is
    its class's colour, and every pixel in no box is background grey, so no
    rectangle reaches past its label's box."""
    sizes = [(64, 64)] * 20 + [(97, 131)] * 10
    src = synth_set(5, sizes, noise=0)
    for img, lb, (h, w) in zip(src["images"], src["labels"], sizes):
        covered = np.zeros((h, w), bool)
        for row in lb[::-1]:
            c, x1, y1, bw, bh = _boxes_px(row, h, w)
            mask = np.zeros((h, w), bool)
            mask[y1:y1 + bh, x1:x1 + bw] = True
            assert (img[mask & ~covered] == SYNTH_COLORS[c]).all()
            covered |= mask
        grey = img[~covered]
        assert grey.size and ((grey >= 90) & (grey < 130)).all()


def test_class_reads_from_the_pixel_colour():
    """With the noise: the channel that dominates a label's visible pixels
    names its class (class 0 red, 1 green, 2 blue, in BGR)."""
    sizes = [(64, 64)] * 30
    src = synth_set(6, sizes)
    seen = 0
    for img, lb in zip(src["images"], src["labels"]):
        covered = np.zeros((64, 64), bool)
        for row in lb[::-1]:
            c, x1, y1, bw, bh = _boxes_px(row, 64, 64)
            mask = np.zeros((64, 64), bool)
            mask[y1:y1 + bh, x1:x1 + bw] = True
            visible = mask & ~covered
            if visible.any():
                mean = img[visible].astype(np.float64).mean(0)
                assert int(np.argmax(mean)) == 2 - c and mean.max() - mean.min() > 150
                seen += 1
            covered |= mask
    assert seen >= 40


def test_val_sizes_are_long_side_640_in_several_ratios():
    sizes = synth_val_sizes(1, 64)
    assert sizes == synth_val_sizes(1, 64) and len(sizes) == 64
    assert all(max(hw) == 640 for hw in sizes)
    assert {round(h / w, 2) for h, w in sizes} == {round(r, 2) for r in SYNTH_VAL_RATIOS}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("overfit")
    data = OF.synth_data(img=64, n_train=8, n_val=6)
    evals = []
    res = OF.train(4, str(root), data, device="cpu", graph=TINY_GRAPH, img=64, batch=4,
                   eval_every=1, workers=2, on_eval=evals.append)
    return root, data, res, evals


def test_overfit_trains_two_epochs_on_the_cpu(trained):
    root, data, res, evals = trained
    assert res["steps"] == 4 and res["epochs"] == 2 and res["dw_sites"] > 0
    assert [e["epoch"] for e in evals] == [0, 1] and [e["step"] for e in evals] == [2, 4]
    assert res["curve"] == evals
    for e in evals:
        assert e["loss"].keys() == {"loss", "iou", "dfl", "cls"}
        assert all(np.isfinite(v) for v in e["loss"].values())
        assert 0.0 <= e["AP50"] <= 1.0 and 0.0 <= e["AP"] <= e["AP50"]
        assert e["lr_weight"] > 0 and e["img_per_s"] > 0
    # the CPU takes the plain versions: no kernel launch is counted
    assert not any(res["launches"]["steps"].values())
    last = load_checkpoint(res["last_ckpt"])
    assert "opt" not in last and last["ema"] is None and last["epoch"] == 1
    assert all(v.dtype == np.float16 for v in _leaves(last["model"]))
    with pytest.raises(ValueError, match="whole epochs"):
        OF.train(3, str(root / "x"), data, device="cpu", graph=TINY_GRAPH, img=64, batch=4)


def test_overfit_stops_early_on_a_longer_schedule(tmp_path):
    """The first 2 steps of a 4-epoch run: the Trainer's schedule and eval
    rule are the longer run's, and only its epoch 0 is trained."""
    data = OF.synth_data(img=64, n_train=8, n_val=4)
    evals = []
    res = OF.train(2, str(tmp_path), data, device="cpu", graph=TINY_GRAPH, img=64, batch=4,
                   eval_every=1, workers=2, on_eval=evals.append, schedule_steps=8)
    assert res["steps"] == 2 and res["epochs"] == 4
    assert [(e["epoch"], e["step"]) for e in evals] == [(0, 2)]
    assert load_checkpoint(res["last_ckpt"])["epoch"] == 0
    with pytest.raises(ValueError, match="whole epochs"):
        OF.train(4, str(tmp_path), data, device="cpu", graph=TINY_GRAPH, img=64, batch=4,
                 schedule_steps=2)


def test_overfit_serves_every_path_on_the_cpu(trained):
    """serve() on the last checkpoint: f32 and bf16 evals, the quantize
    CLI's three modes, and each exported program (none, int8) scored the same
    as the eager function it was traced from."""
    root, data, res, _ = trained
    out = OF.serve(res["last_ckpt"], data, str(root), device="cpu", img=64, batch=4,
                   workers=2, calib_batches=1)
    assert list(out["quant"]) == ["fp", "int8-sim", "int8-real"]
    for tag in ("f32", "bf16"):
        assert {"AP", "AP50"} <= out[tag].keys()
    for quant in ("none", "int8"):
        assert out["export"][quant]["program"] == out["export"][quant]["eager"]
    assert os.path.exists(out["calib_ckpt"])
    with open(out["calib_ckpt"], "rb") as f:
        assert pickle.load(f)["quant"]


def test_static_batch_pads_a_short_batch():
    import torch
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return {"valid": x.sum((1, 2, 3)) > 0}
    got = OF.static_batch(fn, 4)(torch.ones(3, 2, 2, 3, dtype=torch.uint8))
    assert seen == [4] and got["valid"].tolist() == [True] * 3


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]
