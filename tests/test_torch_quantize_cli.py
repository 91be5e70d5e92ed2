"""The port's quantize CLI (python -m mafyolo_tpu_torch.tools.quantize
--device cpu) against the JAX one (tools/quantize.py) on
`make_synth_dataset` (4 train and 4 val images, 3 classes) at 64 px, bs 2,
two calibration batches (every image: the max calibration is then
independent of the shuffle), MAF-YOLO-N on random folded weights; and the
train CLI's --quant --calib route to it."""
import importlib
import pickle

import jax
import numpy as np
import pytest

from mafyolo_tpu.core import quant as JQ
from mafyolo_tpu.utils.checkpoint import eval_variables as jax_eval_variables
from mafyolo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from mafyolo_tpu_torch.core import quant as Q
from mafyolo_tpu_torch.tools import quantize as port_q
from mafyolo_tpu_torch.tools import train as port_train
from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
from tests.helpers import make_synth_dataset
from torch_common import random_folded, to_jax, tree_leaves, u8_images

NC, IMG = 3, 64


def _argv(weights, data, out, *extra):
    return ["--weights", weights, "--data", data, "--img-size", str(IMG),
            "--batch-size", "2", "--calib-batches", "2", "--workers", "1", "--out", out,
            *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("quantize_cli")
    data = str(make_synth_dataset(root / "ds", n_images=4, img_size=IMG, nc=NC, seed=3))
    weights = str(root / "fold.npck")
    folded = random_folded("maf-yolo-n", NC, seed=2)
    with open(weights, "wb") as f:
        pickle.dump({"model": folded, "folded": True, "ema": None,
                     "meta": {"graph": "maf-yolo-n", "nc": NC}}, f, protocol=4)
    jax_cli = importlib.import_module("tools.quantize")
    jax_out, port_out = str(root / "jax_calib.npck"), str(root / "port_calib.npck")
    jax_cli.run(jax_cli.get_args_parser().parse_args(_argv(weights, data, jax_out)))
    metrics = port_q.run(port_q.get_args_parser().parse_args(
        _argv(weights, data, port_out, "--eval", "--device", "cpu")))
    return dict(root=root, data=data, weights=weights, folded=folded, jax_out=jax_out,
                port_out=port_out, metrics=metrics)


def test_calibrated_checkpoints_match_and_cross_load(runs):
    """Both files hold {model: folded params, quant, folded: True, meta, ema:
    None}; the amax trees agree at rtol 1e-6 on the same 88 paths, the
    params are the input's; each package reads the other's file through
    its load_checkpoint and eval_variables, and predicts from it (the port
    in real int8, JAX in fake-quant)."""
    jck, pck = jax_load_checkpoint(runs["port_out"]), load_checkpoint(runs["jax_out"])
    for ck in (jck, pck):
        assert ck["folded"] is True and ck["ema"] is None
        assert ck["meta"] == {"graph": "maf-yolo-n", "nc": NC}
    want = dict(tree_leaves(jax.tree.map(np.asarray, pck["quant"])))
    got = dict(tree_leaves(jck["quant"]))
    assert got.keys() == want.keys() and len(got) == 88
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    src = dict(tree_leaves(runs["folded"]))
    for ck in (jck, pck):
        leaves = dict(tree_leaves(jax.tree.map(np.asarray, jax_eval_variables(ck))))
        assert {k: v for k, v in leaves.items() if k.startswith("params/")}.keys() == src.keys()
        for k, v in src.items():
            np.testing.assert_array_equal(leaves[k], v)
    imgs = u8_images(4, (2, IMG, IMG, 3))
    folded = jax.tree.map(np.asarray, {"params": eval_variables(pck)["params"]})
    out = Q.int8_predict_fn("maf-yolo-n", NC, folded, jax.tree.map(np.asarray, pck["quant"]),
                            conf_thres=0.001, device="cpu")(imgs)
    assert out["boxes"].shape == (2, 300, 4)
    jout = JQ.quantized_predict_fn("maf-yolo-n", NC, {"params": to_jax(jck["model"]["params"])},
                                   to_jax(jck["quant"]), conf_thres=0.001)(imgs)
    assert jout["boxes"].shape == (2, 300, 4)


def test_eval_reports_three_modes(runs):
    """--eval evaluates fp, int8-sim and int8-real, each a COCO AP."""
    m = runs["metrics"]
    assert list(m) == ["fp", "int8-sim", "int8-real"]
    assert all(0.0 <= m[k]["AP"] <= 1.0 and "AP50" in m[k] for k in m)


def test_sensitivity_writes_the_layer_names(runs):
    """--sensitivity quantizes one layer at a time: the file ranks exactly
    the JAX tree's quant_layer_names, one line each (name, AP50, AP)."""
    out = runs["root"] / "sens.txt"
    assert port_q.run(port_q.get_args_parser().parse_args(_argv(
        runs["weights"], runs["data"], str(runs["root"] / "unused.npck"), "--sensitivity",
        "--sensitivity-out", str(out), "--device", "cpu"))) == {}
    rows = [ln.split() for ln in out.read_text().splitlines()]
    assert all(len(r) == 3 for r in rows)
    names = [r[0] for r in rows]
    assert sorted(names) == JQ.quant_layer_names(load_checkpoint(runs["jax_out"])["quant"])
    aps = [float(r[2]) for r in rows]
    assert aps == sorted(aps)


def test_train_cli_quant_calib_routes_to_quantize(runs, monkeypatch, tmp_path):
    """--quant --calib calls tools/quantize.run on --pretrained with --eval
    and the train CLI's data, size, batch and device; without --pretrained
    it exits with a message, as the JAX CLI does."""
    seen = []
    monkeypatch.setattr(port_q, "run", lambda args: seen.append(args) or {"fp": {}})
    base = ["--quant", "--calib", "--data", runs["data"], "--img-size", str(IMG),
            "--batch-size", "2", "--device", "cpu", "--output-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="--pretrained"):
        port_train.main(port_train.get_args_parser().parse_args(base))
    assert port_train.main(port_train.get_args_parser().parse_args(
        base + ["--pretrained", runs["weights"]])) == {"fp": {}}
    (args,) = seen
    assert (args.weights, args.data, args.img_size, args.batch_size, args.eval,
            args.device) == (runs["weights"], runs["data"], IMG, 2, True, "cpu")
