"""The port's reader of reference `.pt` checkpoints
(mafyolo_tpu_torch/utils/torch_bridge.py) against the JAX package's
(mafyolo_tpu/utils/torch_bridge.py), on the CPU.

No released checkpoint is in the repository, so each `.pt` is written here
from random train-form weights in the reference's key layout
(utils/sample.py:reference_state_dict, the inverse of convert_layer, itself
held against JAX's state_dict_to_variables). Loads are compared leaf for
leaf and exactly; predictions from a `.pt` through the port's Evaler
against the JAX Evaler's from the same file, f32 at 64 px, with
tests/test_torch_eval.py's rule; the CLIs and the Trainer's --pretrained
on a `.pt` against the same weights in a `.npck`, exactly."""
import pickle

import jax
import numpy as np
import pytest
import torch

from mafyolo_tpu.core.evaler import Evaler as JaxEvaler
from mafyolo_tpu.utils import torch_bridge as J
from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.utils import torch_bridge as B
from mafyolo_tpu_torch.utils.bridge import random_train_variables
from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
from mafyolo_tpu_torch.utils.sample import reference_state_dict
from torch_common import prior_head_weights, to_jax, tree_leaves, u8_images

NC = 6


def _variables(graph, seed):
    return random_train_variables(build_model(graph, nc=NC).specs, seed=seed)


def _write_pt(path, sd, key="model", **extra):
    torch.save({key: sd, **extra}, path)
    return str(path)


def _assert_trees_equal(got, want):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys() and len(want) > 100
    for k, w in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], w), k


@pytest.mark.parametrize("graph", ["maf-yolo-n", "maf-yolo-s"])
def test_inverse_round_trips_through_jax_state_dict_to_variables(graph):
    """reference_state_dict writes the reference's keys: JAX's reader gives
    the weights back exactly, and the keys carry the reference's quirks."""
    specs = build_model(graph, nc=NC).specs
    variables = _variables(graph, 1)
    sd = reference_state_dict(variables, specs)
    _assert_trees_equal(jax.tree.map(np.asarray, J.state_dict_to_variables(sd, specs)),
                        variables)
    assert all(k.startswith("backbone.") for k in sd)
    for spec in specs:
        pfx = f"backbone.{spec.idx}"
        if spec.kind == "RepVGGBlock":
            identity = spec.kw["cin"] == spec.kw["cout"] and spec.kw["stride"] == 1
            assert (f"{pfx}.rbr_identity.weight" in sd) == identity
        if spec.kind == "MPRep":
            assert f"{pfx}.conv1.conv.weight" in sd and f"{pfx}.conv2.rbr_dense.conv.weight" in sd
        if spec.kind == "Head_DepthUni":
            assert f"{pfx}.cls_conv_s.conv.weight" in sd and f"{pfx}.reg_conv_s.bn.weight" in sd
    assert any(".dil_conv_k" in k and k.endswith("_1.weight") for k in sd)
    assert any(".dil_bn_k" in k for k in sd)


@pytest.mark.parametrize("graph,seed", [("maf-yolo-n", 2), ("maf-yolo-s", 3),
                                        ("maf-yolo-m", 4)])
def test_load_torch_checkpoint_matches_jax(graph, seed, tmp_path):
    """The port's load_torch_checkpoint equals JAX's leaf for leaf (N and S;
    M against the weights written, JAX's reader being N's and S's code), the
    graph read off the head stem's width and nc off cls_pred."""
    specs = build_model(graph, nc=NC).specs
    variables = _variables(graph, seed)
    path = _write_pt(tmp_path / "w.pt", reference_state_dict(variables, specs))
    got = B.load_torch_checkpoint(path)
    assert got["meta"] == {"graph": graph, "nc": NC}
    assert got["ema"] is None and got["opt"] is None and got["epoch"] == -1
    _assert_trees_equal(got["model"], variables)
    if graph != "maf-yolo-m":
        want = J.load_torch_checkpoint(path)
        assert want["meta"] == got["meta"]
        _assert_trees_equal(got["model"], jax.tree.map(np.asarray, want["model"]))
    assert load_checkpoint(path)["meta"] == got["meta"]


def test_ema_or_model_and_graph_by_width(tmp_path):
    """`ema` when truthy, else `model`, in both packages; a head stem whose
    width is none of N's, S's or M's reads as N."""
    specs = build_model("maf-yolo-n", nc=NC).specs
    a, b = _variables("maf-yolo-n", 5), _variables("maf-yolo-n", 6)
    sd_a, sd_b = reference_state_dict(a, specs), reference_state_dict(b, specs)
    for ema, want in ((sd_a, a), (None, b), ({}, b)):
        path = _write_pt(tmp_path / "e.pt", sd_b, ema=ema)
        _assert_trees_equal(B.load_torch_checkpoint(path)["model"], want)
        _assert_trees_equal(jax.tree.map(np.asarray, J.load_torch_checkpoint(path)["model"]),
                            want)
    assert B.GRAPH_BY_WIDTH == {128: "maf-yolo-n", 192: "maf-yolo-s", 256: "maf-yolo-m"}
    odd = dict(sd_a, **{"backbone.31.stem.conv.weight": torch.zeros(96, 128, 1, 1)})
    path = _write_pt(tmp_path / "odd.pt", odd)
    assert B.load_torch_checkpoint(path)["meta"]["graph"] == "maf-yolo-n" \
        == J.load_torch_checkpoint(path)["meta"]["graph"]


def test_office_kinds_raise():
    """The office graphs' kinds are read (tests/test_torch_office.py holds
    them against JAX); a kind no graph has still raises, as in JAX."""
    from mafyolo_tpu_torch.models.office import office_config_graph
    specs = build_model(office_config_graph("yolov6n-office"), nc=NC).specs
    assert {s.kind for s in specs} >= {"RepBlock", "SimSPPF", "Transpose", "Head_Effide"}
    fake = type(specs[0])(idx=0, frm=(-1,), kind="Unknown", kwargs=(), cout=8)
    for convert in (B.convert_layer, J.convert_layer):
        with pytest.raises(NotImplementedError, match="Unknown"):
            convert({}, fake, "backbone.0")


def test_evaler_from_pt_matches_jax_evaler(tmp_path):
    """A `.pt` of N's train-form weights (cls preds at the prior, so boxes
    clear conf 0.03) loaded by each package and served by its Evaler, f32
    at 64 px."""
    from test_torch_eval import _assert_matches
    specs = build_model("maf-yolo-n", nc=NC).specs
    variables = prior_head_weights("maf-yolo-n", NC, seed=7)
    for layer in (31, 32, 33):       # scores spread around the threshold
        pred = variables["params"]["net"][f"layer{layer}"]["cls_pred"]
        pred["kernel"] = pred["kernel"] * 100.0
        pred["bias"] = np.full_like(pred["bias"], -3.0)
    path = _write_pt(tmp_path / "n.pt", reference_state_dict(variables, specs))
    imgs = u8_images(9, (2, 64, 64, 3))
    ckpt = load_checkpoint(path)
    ev = Evaler(half=False, device="cpu")
    ev.init_model(ckpt["meta"]["graph"], ckpt["model"], NC, folded=False)
    got = {k: v.numpy() for k, v in ev.predict(torch.from_numpy(imgs)).items()}
    jckpt = J.load_torch_checkpoint(path)
    jev = JaxEvaler({"nc": NC}, img_size=64, half=False)
    jev.init_model(jckpt["meta"]["graph"], to_jax(jax.tree.map(np.asarray, jckpt["model"])),
                   NC, folded=False)
    want = {k: np.asarray(v) for k, v in jev._predict(imgs).items()}
    _assert_matches(got, want)


@pytest.fixture(scope="module")
def same_weights(tmp_path_factory):
    """N's train-form weights as a `.pt` and as a `.npck`, and a synth set."""
    from mafyolo_tpu_torch.utils.events import load_yaml
    from tests.helpers import make_synth_dataset
    root = tmp_path_factory.mktemp("pt")
    specs = build_model("maf-yolo-n", nc=NC).specs
    variables = prior_head_weights("maf-yolo-n", NC, seed=8)
    pt = _write_pt(root / "w.pt", reference_state_dict(variables, specs))
    npck = str(root / "w.npck")
    with open(npck, "wb") as f:
        pickle.dump({"model": variables, "ema": None, "meta": {"graph": "maf-yolo-n",
                                                               "nc": NC}}, f)
    yaml_path = make_synth_dataset(root / "ds", n_images=6, img_size=64, nc=NC, seed=2)
    return dict(root=root, variables=variables, pt=pt, npck=npck, yaml=str(yaml_path),
                data=load_yaml(str(yaml_path)))


def test_eval_infer_quantize_clis_take_pt(same_weights, tmp_path, monkeypatch):
    """The eval, infer and quantize CLIs on the `.pt` give what they give on
    the `.npck` of the same weights: metrics, detection lines, amax tree."""
    from mafyolo_tpu_torch.tools import eval as eval_cli
    from mafyolo_tpu_torch.tools import infer as infer_cli
    from mafyolo_tpu_torch.tools import quantize as quantize_cli
    monkeypatch.chdir(tmp_path)
    w = same_weights
    common = ["--data", w["yaml"], "--img-size", "64", "--batch-size", "3", "--workers", "1",
              "--device", "cpu"]
    metrics = [eval_cli.run(eval_cli.get_args_parser().parse_args(
        ["--weights", p, "--half", "0"] + common)) for p in (w["pt"], w["npck"])]
    assert metrics[0] == metrics[1] and len(metrics[0]) > 2
    src = w["root"] / "ds" / "images" / "val"
    for p, out in ((w["pt"], "a"), (w["npck"], "b")):
        infer_cli.run(infer_cli.get_args_parser().parse_args(
            ["--weights", p, "--source", str(src), "--img-size", "64", "--conf-thres", "0.01",
             "--save-txt", "--half", "0", "--device", "cpu", "--save-dir", str(tmp_path / out)]))
    texts = [{f.name: f.read_text() for f in (tmp_path / d).glob("*.txt")} for d in "ab"]
    assert texts[0] == texts[1] and len(texts[0]) == 6
    trees = []
    for p in (w["pt"], w["npck"]):
        out = str(tmp_path / (p.rsplit("/", 1)[1] + "_calib.npck"))
        quantize_cli.run(quantize_cli.get_args_parser().parse_args(
            ["--weights", p, "--calib-batches", "1", "--out", out] + common))
        with open(out, "rb") as f:
            trees.append(dict(tree_leaves(pickle.load(f)["quant"])))
    assert trees[0].keys() == trees[1].keys() and len(trees[0]) > 50
    assert all(np.array_equal(trees[0][k], trees[1][k]) for k in trees[0])


def test_trainer_pretrained_pt(same_weights, tmp_path):
    """--pretrained x.pt: the Trainer's model and EMA start from the `.pt`'s
    weights (every leaf shape-matched), and a step runs from there."""
    from types import SimpleNamespace

    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    from mafyolo_tpu_torch.utils.config import Config
    w = same_weights
    args = SimpleNamespace(img_size=64, batch_size=2, epochs=1, workers=1, seed=0,
                           save_dir=str(tmp_path), tensorboard=False, pretrained=w["pt"])
    tr = Trainer(args, Config.fromfile("configs/maf_yolo_n.py"), w["data"], device="cpu")
    got = state_dict_to_train_variables(dict(tr.state.model.named_parameters()))
    for k, v in tree_leaves(w["variables"]["params"]):
        assert np.array_equal(dict(tree_leaves(got["params"]))[k], v), k
    imgs, targets, _ = next(iter(tr.train_loader))
    met = tr._train_steps(0, [(torch.from_numpy(imgs), torch.from_numpy(targets))])[0]
    assert all(np.isfinite(float(v)) for v in met.values())
