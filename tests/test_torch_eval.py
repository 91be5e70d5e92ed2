"""The port's eval loop and CLIs against the JAX package's, f32 on the CPU.

The set: 8 synth images of 72-119 px (textured, so no two anchors tie),
evaluated at 96 px with random folded MAF-YOLO-N weights (about 70
detections an image at conf 0.03). Its labels are rewritten from the JAX
Evaler's own detections (the top 10 of an image, each box moved by N(0,
3 px)), so that AP and P/R sit between 0 and 1 and a wrong match, rescale or
class mapping moves them."""
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest

from mafyolo_tpu.core.evaler import Evaler as JaxEvaler
from mafyolo_tpu.utils.checkpoint import save_checkpoint
from mafyolo_tpu_torch.core.evaler import Evaler, run_eval
from mafyolo_tpu_torch.tools import eval as eval_cli
from mafyolo_tpu_torch.tools import infer as infer_cli
from mafyolo_tpu_torch.utils.events import load_yaml
from tests.helpers import make_synth_dataset
from torch_common import random_folded, to_jax

NC = 3
KW = dict(img_size=96, batch_size=4, half=False, workers=2, do_pr_metric=True,
          plot_curve=False)


def _relabel(dataset, preds, rng):
    """Write each image's label file from its 10 best detections, moved."""
    by_image = {}
    for d in preds:
        by_image.setdefault(d["image_id"], []).append(d)
    for i, path in enumerate(dataset.img_paths):
        w, h = dataset.shapes[i]
        best = sorted(by_image.get(dataset.image_id(i), []), key=lambda d: -d["score"])[:10]
        lines = []
        for d in best:
            x, y, bw, bh = np.array(d["bbox"]) + rng.normal(0, 3.0, 4)
            lines.append(f"{d['category_id']} {(x + bw / 2) / w:.6f} {(y + bh / 2) / h:.6f} "
                         f"{bw / w:.6f} {bh / h:.6f}")
        label = path.replace("/images/", "/labels/").rsplit(".", 1)[0] + ".txt"
        Path(label).write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(data_dict, folded weights, the JAX Evaler's detections, per-image
    predict outputs and metrics on the relabelled set, the JAX Evaler)."""
    root = tmp_path_factory.mktemp("eval")
    data = load_yaml(make_synth_dataset(root, n_images=8, img_size=96, nc=NC, seed=1,
                                        splits=("val",), noise=6))
    folded = random_folded("maf-yolo-n", NC, seed=0)
    jev = JaxEvaler(data, save_dir=str(root), **KW)
    jev.init_model("maf-yolo-n", to_jax(folded), NC, folded=True)
    first = jev.predict_model(jev.init_data())
    _relabel(jev.dataset, first, np.random.default_rng(0))
    raw = []
    predict = jev._predict
    jev._predict = lambda imgs: raw.append(predict(imgs)) or raw[-1]
    preds = jev.predict_model(jev.init_data())
    jev._predict = predict
    metrics = jev.eval_model(preds)
    return dict(root=root, data=data, folded=folded, preds=preds, metrics=metrics,
                raw=[{k: np.asarray(v) for k, v in o.items()} for o in raw], jev=jev)


def _assert_matches(got, want):
    """tests/test_torch_slice.py's rule: equal counts per image; every JAX
    detection has a port detection of its class, score within 1e-3 and box
    within 1e-2 px."""
    n = want["valid"].sum(1)
    np.testing.assert_array_equal(got["valid"].sum(1), n)
    assert n.min() >= 5
    for i in range(len(n)):
        k = n[i]
        for box, score, cls in zip(want["boxes"][i, :k], want["scores"][i, :k],
                                   want["classes"][i, :k]):
            cand = np.flatnonzero((got["classes"][i, :k] == cls)
                                  & (np.abs(got["scores"][i, :k] - score) <= 1e-3))
            err = np.abs(got["boxes"][i, cand] - box).max(-1) if len(cand) else []
            assert len(cand) and np.min(err) <= 1e-2, (i, box, score, cls)


def test_predict_model_and_eval_match_jax(synth):
    """Per batch, the port's predict output matches the JAX Evaler's; the
    COCO metrics and P/R/F1/mAP of the whole loop are within 1e-6 of its;
    so are the COCO numbers and the PR numbers from either package's
    detections fed to the other's metrics."""
    ev = Evaler(synth["data"], save_dir=str(synth["root"]), device="cpu", **KW)
    ev.init_model("maf-yolo-n", synth["folded"], NC, folded=True)
    raw = []
    predict = ev.predict
    ev.predict = lambda imgs: raw.append(predict(imgs)) or raw[-1]
    preds = ev.predict_model(ev.init_data())
    assert len(raw) == len(synth["raw"]) == 2
    for got, want in zip(raw, synth["raw"]):
        _assert_matches({k: v.numpy() for k, v in got.items()}, want)
    assert len(preds) == len(synth["preds"])
    assert ev.speed_result[0] == 8 and (ev.speed_result[1:] > 0).all()
    got = ev.eval_model(preds)
    want = synth["metrics"]
    assert 0.2 < want["AP"] < 0.95 and 0.2 < want["P"] < 1 and 0.2 < want["R"] < 1, want
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
    # the same detections through each package's metrics: equal
    jev = synth["jev"]
    assert ev.eval_model(synth["preds"])["AP"] == pytest.approx(want["AP"], abs=1e-6)
    ev._pr_stats, ev._pr_seen = jev._pr_stats, jev._pr_seen
    assert ev.compute_pr_metrics() == jev.compute_pr_metrics()


def test_run_eval_matches_evaler(synth):
    """run_eval (the CLI's and trainer's one call) gives the loop's metrics,
    and hands the first images' native-space detections to on_vis."""
    seen = []
    got = run_eval("maf-yolo-n", synth["folded"], NC, synth["data"], folded=True,
                   on_vis=seen.append, save_dir=str(synth["root"]), device="cpu", **KW)
    for k, v in synth["metrics"].items():
        assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
    assert len(seen) == 1 and len(seen[0]) == 8 and seen[0][0].ndim == 3


def _checkpoint(synth, tmp_path):
    ckpt = {"model": synth["folded"], "folded": True,
            "meta": {"graph": "maf-yolo-n", "nc": NC}}
    return save_checkpoint(ckpt, False, str(tmp_path))


def test_eval_cli_matches_jax_cli(synth, tmp_path, monkeypatch):
    """tools/eval.py run(args) on a .npck the JAX package wrote: the port's
    CLI gives the JAX CLI's metrics within 1e-6, and the same detection
    list (ids and classes equal, boxes within 0.01 px, scores 1e-4). Both
    CLIs write their PR curves into the working directory."""
    import tools.eval as jax_eval_cli
    monkeypatch.chdir(tmp_path)
    path = _checkpoint(synth, tmp_path)
    yaml_path = str(synth["root"] / "dataset.yaml")
    argv = ["--weights", path, "--data", yaml_path, "--img-size", "96", "--batch-size", "4",
            "--half", "0", "--workers", "2", "--do_pr_metric"]
    got = eval_cli.run(eval_cli.get_args_parser().parse_args(
        argv + ["--device", "cpu", "--save-json", str(tmp_path / "port.json")]))
    want = jax_eval_cli.run(jax_eval_cli.get_args_parser().parse_args(
        argv + ["--save-json", str(tmp_path / "jax.json")]))
    assert got.keys() == want.keys() and want["AP"] > 0.2
    assert (tmp_path / "PR_curve.png").exists()
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
    port_dets, jax_dets = (json.loads((tmp_path / f).read_text())
                           for f in ("port.json", "jax.json"))
    key = lambda d: (d["image_id"], d["category_id"], -d["score"])  # noqa: E731
    assert len(port_dets) == len(jax_dets)
    for a, b in zip(sorted(port_dets, key=key), sorted(jax_dets, key=key)):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-4
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-2)


def test_infer_cli_matches_jax_cli(synth, tmp_path):
    """tools/infer.py run(args) --save-txt on two images (one 96x96 letterbox
    each, the front-end route) against the JAX CLI (decode_eval +
    batched_nms(multi_label=False)): the same lines, classes equal, scores
    within 1e-3; boxes within 1e-3 of the image size, or one pixel where
    the CLI's truncation to whole pixels moves a corner."""
    import tools.infer as jax_infer_cli
    src = tmp_path / "src"
    src.mkdir()
    for p in sorted((synth["root"] / "images" / "val").glob("*.jpg"))[:2]:
        shutil.copy(p, src / p.name)
    argv = ["--weights", _checkpoint(synth, tmp_path), "--source", str(src), "--img-size",
            "96", "--conf-thres", "0.2", "--save-txt", "--half", "0"]
    infer_cli.run(infer_cli.get_args_parser().parse_args(
        argv + ["--save-dir", str(tmp_path / "port"), "--device", "cpu"]))
    jax_infer_cli.run(jax_infer_cli.get_args_parser().parse_args(
        argv + ["--save-dir", str(tmp_path / "jax")]))
    n_lines = 0
    for txt in sorted((tmp_path / "jax").glob("*.txt")):
        want = [np.array(ln.split(), float) for ln in txt.read_text().splitlines()]
        got = [np.array(ln.split(), float)
               for ln in (tmp_path / "port" / txt.name).read_text().splitlines()]
        assert len(got) == len(want)
        wh = np.array([96.0, 96.0])
        for g, w in zip(got, want):
            assert g[0] == w[0] and abs(g[5] - w[5]) <= 1e-3
            assert (np.abs(g[1:5] - w[1:5]) <= np.maximum(1e-3, 1.0 / np.tile(wh, 2))).all()
        n_lines += len(want)
    assert n_lines >= 4
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_checkpoint_reads_jax_npck(synth, tmp_path):
    """load_checkpoint reads the JAX package's .npck without JAX types in
    it; eval_variables prefers the EMA."""
    from mafyolo_tpu_torch.utils.checkpoint import eval_variables, load_checkpoint
    path = _checkpoint(synth, tmp_path)
    ckpt = load_checkpoint(path)
    with open(path, "rb") as f:
        assert pickle.load(f)["meta"] == ckpt["meta"]
    params = eval_variables(ckpt)["params"]
    assert params["net"]["layer0"].keys() == synth["folded"]["params"]["net"]["layer0"].keys()
    ema = {"params": {"x": np.ones(2)}, "batch_stats": {}}
    assert eval_variables({"model": ckpt["model"], "ema": ema})["params"] is ema["params"]
