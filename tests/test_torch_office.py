"""The YOLOv6 office graphs (models/office.py) in the port against the JAX
package on the CPU: the graph dicts of the three configurations
(OFFICE_CONFIGS: N, M and L at full width), the folds leaf for leaf and the
folded deploy model against JAX's, fold_replk, the `.pt` reader at the
office prefixes, and office N served by the Evaler (the front-end's
layers-0-1 route) against the JAX Evaler. The train forms, the train step
and the Trainer are in tests/test_torch_office_train.py.

Inputs come from numpy seeds: every leaf of the random train trees is
nonzero (utils/bridge.py:random_train_variables). The folds are held at
1e-6 relative (numpy on both sides, the same operations), the deploy
forwards at atol 1e-4, rtol 1e-3 (f32 convolutions, summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.core.evaler import Evaler as JaxEvaler
from mafyolo_tpu.models import blocks as JB
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models import office as JO
from mafyolo_tpu.models.reparam import fold_replk as jax_fold_replk
from mafyolo_tpu.models.reparam import fold_variables as jax_fold_variables
from mafyolo_tpu.utils import torch_bridge as JTB
from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.models import blocks as B
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models import office as O
from mafyolo_tpu_torch.models.reparam import fold_replk, fold_variables
from mafyolo_tpu_torch.utils import torch_bridge as TB
from mafyolo_tpu_torch.utils.bridge import (_random_state_dict, folded_to_state_dict,
                                            random_folded_variables,
                                            random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from mafyolo_tpu_torch.utils.sample import reference_state_dict
from torch_common import to_jax, tree_leaves, u8_images

NC = 7
NAMES = tuple(O.OFFICE_CONFIGS)


@pytest.mark.parametrize("name", NAMES)
def test_office_graph_equals_jax(name):
    """The graph dict, its parse and the published widths: N's channels
    [16, 32, 64, 128, 256, 64, 32, 32, 64, 64, 128] with RepBlock chains of
    2, 4, 6, 2 in the backbone and 4 in the neck."""
    model_cfg, mode = O.OFFICE_CONFIGS[name]
    graph = O.office_graph(model_cfg, mode)
    assert graph == JO.office_graph(model_cfg, mode) == O.office_config_graph(name)
    assert O.OFFICE_TORCH_PREFIXES == JO.OFFICE_TORCH_PREFIXES
    assert O.make_divisible(0.25 * 1024) == JO.make_divisible(0.25 * 1024) == 256
    assert [dataclasses.astuple(s) for s in build_model(graph, nc=NC).specs] == \
        [dataclasses.astuple(s) for s in jax_build_model(graph, nc=NC).specs]
    if name == "yolov6n-office":
        _, ch, _ = O._scaled(model_cfg)
        assert ch == [16, 32, 64, 128, 256, 64, 32, 32, 64, 64, 128]
        reps = [row[1] for row in graph["backbone"] + graph["neck"] if row[2] == "RepBlock"]
        assert reps == [2, 4, 6, 2, 4, 4, 4, 4]
    kinds = {row[2] for row in graph["backbone"] + graph["neck"]}
    assert kinds >= ({"RepBlock", "SimSPPF"} if name == "yolov6n-office"
                     else {"BepC3", "SPPF" if name == "yolov6l-office" else "SimSPPF"})


def test_office_graph_rejects_other_types():
    cfg = dict(O.OFFICE_CONFIGS["yolov6n-office"][0], backbone=dict(type="Other"))
    for fn in (O.office_graph, JO.office_graph):
        with pytest.raises(NotImplementedError, match="Other"):
            fn(cfg)


@pytest.mark.parametrize("name", NAMES)
def test_fold_matches_jax_and_deploy_forward(name):
    """Leaf for leaf against the JAX fold (BepC3's alpha carried, the
    Transpose kernel and bias through), and the folded model against the
    port's train form in eval mode on that random tree, within 1e-4 of each
    output's largest magnitude floored at 1 (its activations reach 1e2 in N
    and 1e5 in M: the random BN statistics and RepVGG sums grow them, and
    the f32 sums' rounding with them); then the port's
    deploy model against the JAX deploy model at 64 px on a random folded
    tree whose activations stay below 1 (atol 1e-4, rtol 1e-3)."""
    graph = O.office_config_graph(name)
    model = build_model(graph, nc=NC)
    variables = random_train_variables(model.specs, seed=6)
    folded = fold_variables(model.specs, variables)
    got = dict(tree_leaves(folded))
    want = dict(tree_leaves(jax_fold_variables(model.specs, variables)))
    assert got.keys() == want.keys()
    assert any(k.endswith("alpha") for k in got) == (name != "yolov6n-office")
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7, err_msg=k)

    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    deploy = build_model(graph, nc=NC, deploy=True)
    deploy.load_state_dict(folded_to_state_dict(folded))
    model.load_state_dict(train_variables_to_state_dict(variables))
    with torch.no_grad():
        got_out = deploy.eval()(torch.from_numpy(x))
        train_eval = model.eval()(torch.from_numpy(x))
    for g_level, t_level in zip(got_out, train_eval):
        for g, t in zip(g_level, t_level):
            torch.testing.assert_close(g, t, rtol=0,
                                       atol=1e-4 * max(1.0, float(t.abs().max())))

    folded = random_folded_variables(model.specs, seed=2)
    deploy.load_state_dict(folded_to_state_dict(folded))
    with torch.no_grad():
        got_out = deploy(torch.from_numpy(x))
    want_out = jax_build_model(graph, nc=NC, deploy=True).apply(
        to_jax(folded), jnp.asarray(x), train=False)
    for g_level, w_level in zip(got_out, want_out):
        for g, w in zip(g_level, w_level):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3)
    assert float(np.asarray(want_out[0][2]).std()) > 0.1


def test_fold_replk_and_reparam_large_kernel_conv():
    """The train form against the JAX module on random nonzero variables,
    fold_replk leaf for leaf against JAX's, and the folded deploy form
    against the train form (tests/test_reparam.py:79-90)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (1, 10, 10, 8)).astype(np.float32)
    mod = B.ReparamLargeKernelConv(8, 7, small_k=3)
    variables = _random_state_dict(mod, 3, 1.0)       # "net."-prefixed, every leaf nonzero
    tree = state_dict_to_train_variables(variables)
    p, s = tree["params"]["net"], tree["batch_stats"]["net"]
    mod.load_state_dict({k[4:]: v for k, v in variables.items()})
    y_train = mod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    y_jax = JB.ReparamLargeKernelConv(ch=8, k=7, small_k=3).apply(
        {"params": to_jax(p), "batch_stats": to_jax(s)}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(y_train.detach().numpy(), np.asarray(y_jax), atol=1e-5, rtol=1e-5)

    folded = fold_replk(p, s, 7, 3)
    want = jax_fold_replk(p, s, 7, 3)
    for (k, g), (k2, w) in zip(tree_leaves(folded), tree_leaves(want)):
        assert k == k2
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    dep = B.ReparamLargeKernelConv(8, 7, small_k=3, deploy=True)
    dep.load_state_dict({k[4:]: v for k, v in folded_to_state_dict(
        {"params": {"net": folded}}).items()})
    y_dep = dep.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y_dep.detach().numpy(), y_train.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert float(y_dep.detach().std()) > 0.1


@pytest.mark.parametrize("name", NAMES)
def test_office_pt_reads_as_jax(name):
    """A reference state_dict at OFFICE_TORCH_PREFIXES (utils/sample.py:
    reference_state_dict, the inverse of convert_layer: ConvTranspose2d's
    [I, O, kH, kW] weight, the head's per-role ModuleLists, BottleRep's
    alpha) read by each package: both give the tree it was written from."""
    specs = build_model(O.office_config_graph(name), nc=NC).specs
    variables = random_train_variables(specs, seed=8)
    sd = reference_state_dict(variables, specs, prefixes=O.OFFICE_TORCH_PREFIXES)
    assert "neck.upsample0.upsample_transpose.weight" in sd and "detect.stems.2.conv.weight" in sd
    t = sd["neck.upsample0.upsample_transpose.weight"]
    assert t.shape[:2] == (specs[11].kw["cin"], specs[11].kw["cout"])
    got = TB.state_dict_to_variables(sd, specs, prefixes=O.OFFICE_TORCH_PREFIXES)
    want = JTB.state_dict_to_variables(sd, specs, prefixes=JO.OFFICE_TORCH_PREFIXES)
    exp = dict(tree_leaves(variables))
    for tree in (got, want):
        leaves = dict(tree_leaves(tree))
        assert leaves.keys() == exp.keys()
        for k, v in exp.items():
            np.testing.assert_array_equal(np.asarray(leaves[k], np.float32), v, err_msg=k)


def _office_n_with_detections():
    """Random folded office N weights, cls_pred biases shifted so that each
    128 px image has a few hundred (anchor, class) pairs above conf 0.03."""
    specs = build_model(O.office_config_graph("yolov6n-office"), nc=NC).specs
    folded = random_folded_variables(specs, seed=3)
    net = folded["params"]["net"]
    for i in (24, 25, 26):
        net[f"layer{i}"]["cls_pred"]["bias"] = net[f"layer{i}"]["cls_pred"]["bias"] - 2.0
    return folded


def test_office_n_predict_matches_jax_evaler():
    """Office N at 128 px through the port's Evaler (layers 0-1 by the
    front-end's plain version, fe_skip 1) against the JAX Evaler on the
    CPU (its own layers): the rule of tests/test_torch_slice.py, every JAX
    detection found with its class, score within 1e-3, box within 1e-2 px;
    and office L (no front-end route) the same way."""
    from test_torch_slice import _assert_matches
    imgs = u8_images(9, (2, 128, 128, 3))
    for name, fe_skip in (("yolov6n-office", 1), ("yolov6l-office", -1)):
        graph = O.office_config_graph(name)
        if name == "yolov6n-office":
            folded = _office_n_with_detections()
        else:
            folded = random_folded_variables(build_model(graph, nc=NC).specs, seed=4)
            for i in (24, 25, 26):
                pred = folded["params"]["net"][f"layer{i}"]["cls_pred"]
                pred["kernel"] = pred["kernel"] * 0.02
                pred["bias"] = pred["bias"] - 3.0
        ev = Evaler(half=False, device="cpu")
        ev.init_model(graph, folded, nc=NC, folded=True)
        assert ev.fe_skip == fe_skip and (ev.fe_weights is None) == (fe_skip < 0)
        got = {k: v.numpy() for k, v in ev.predict(imgs).items()}
        jev = JaxEvaler({}, half=False)
        jev.init_model(graph, to_jax(folded), NC, folded=True)
        want = jax.tree.map(np.asarray, jev._predict(jnp.asarray(imgs)))
        _assert_matches(got, want)
