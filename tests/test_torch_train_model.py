"""The port's train-form model, held against the JAX train form on the same
random train variables (every leaf nonzero, the preds included), f32 on the
CPU: TINY_GRAPH and MAF-YOLO-N at 64 px.

Tolerances: train-mode outputs atol 1e-4 on TINY_GRAPH (summation order
only, as the deploy tests). N's train forward on 2 images is ill-conditioned
in f32: every BN normalizes by batch statistics, over 8 values per channel
at P5, so rounding grows with depth; an f64 run of the port on the same
weights puts the port's f32 output 6e-4 and the JAX package's 2e-3 away
from it (feat and reg; cls 7e-5 and 2e-4). So N is held at atol 5e-3
against JAX and at 1e-3 against the port's own f64 run. The updated BN
running stats at 1e-5 on TINY_GRAPH and 1e-3 on N, whose deep batch
variances inherit that rounding (torch's unbiased running variance would be
off by 0.03 * var / (n - 1): 4e-3 * var at N's P5, 2e-3 * var at
TINY_GRAPH's P5); the folds leaf for leaf at 1e-6 relative (the same numpy
code)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TINY_GRAPH
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.reparam import fold_variables as jax_fold_variables
from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.reparam import fold_variables
from mafyolo_tpu_torch.utils.bridge import (folded_to_state_dict, random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from torch_common import to_jax, tree_leaves

GRAPHS = {"tiny": TINY_GRAPH, "maf-yolo-n": "maf-yolo-n"}
NC = 7


def _port(graph, variables, seed_img=1, img=64):
    model = build_model(graph, nc=NC)
    model.load_state_dict(train_variables_to_state_dict(variables))
    x = np.random.default_rng(seed_img).uniform(0, 1, (2, img, img, 3)).astype(np.float32)
    return model, x


@pytest.mark.parametrize("name,atol,stats_atol", [("tiny", 1e-4, 1e-5),
                                                  ("maf-yolo-n", 5e-3, 1e-3)])
def test_train_forward_and_bn_stats_match_jax(name, atol, stats_atol):
    graph = GRAPHS[name]
    variables = random_train_variables(build_model(graph, nc=NC).specs, seed=4)
    model, x = _port(graph, variables)
    want, mut = jax.jit(lambda v, a: jax_build_model(graph, nc=NC).apply(
        v, a, train=True, mutable=["batch_stats"]))(to_jax(variables), jnp.asarray(x))
    f64, _ = _port(graph, variables)
    ref = f64.double().train()(torch.from_numpy(x).double())
    got = model.train()(torch.from_numpy(x))
    for g_level, w_level, r_level in zip(got, want, ref):
        for g, w, r in zip(g_level, w_level, r_level):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol, rtol=0)
            np.testing.assert_allclose(g.detach().double().numpy(), r.detach().numpy(),
                                       atol=min(atol, 1e-3), rtol=0)
    assert float(np.asarray(want[0][1]).std()) > 1e-3
    stats = dict(tree_leaves(state_dict_to_train_variables(model.state_dict())["batch_stats"]))
    want_stats = dict(tree_leaves(jax.tree.map(np.asarray, mut["batch_stats"])))
    assert stats.keys() == want_stats.keys() and len(stats) > 10
    old = dict(tree_leaves(variables["batch_stats"]))
    for k, w in want_stats.items():
        assert not np.allclose(w, old[k])          # the step moved every stat
        np.testing.assert_allclose(stats[k], w, atol=stats_atol, rtol=stats_atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_fold_matches_jax_fold_and_train_eval(name):
    """The port's numpy fold equals the JAX fold leaf for leaf, and the folded
    deploy model equals the train form in eval mode."""
    graph = GRAPHS[name]
    model = build_model(graph, nc=NC)
    variables = random_train_variables(model.specs, seed=6)
    folded = fold_variables(model.specs, variables)
    want = dict(tree_leaves(jax_fold_variables(model.specs, variables)))
    got = dict(tree_leaves(folded))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7, err_msg=k)

    model, x = _port(graph, variables, seed_img=2)
    deploy = build_model(graph, nc=NC, deploy=True)
    deploy.load_state_dict(folded_to_state_dict(folded))
    with torch.no_grad():
        got_out = deploy.eval()(torch.from_numpy(x))
        want_out = model.eval()(torch.from_numpy(x))
    for g_level, w_level in zip(got_out, want_out):
        for g, w in zip(g_level, w_level):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_bridge_round_trip_and_tree_layout():
    """state_dict -> JAX tree -> state_dict is the identity, and the tree has
    the JAX train-form model's paths and shapes exactly."""
    model = build_model("maf-yolo-n", nc=NC)
    variables = random_train_variables(model.specs, seed=8)
    sd = train_variables_to_state_dict(variables)
    model.load_state_dict(sd)            # strict: every module entry present
    back = train_variables_to_state_dict(state_dict_to_train_variables(model.state_dict()))
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], atol=0, rtol=0)
    shapes = jax.eval_shape(
        lambda: jax_build_model("maf-yolo-n", nc=NC).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = {k: v.shape for k, v in tree_leaves(jax.tree.map(lambda s: np.zeros(s.shape), shapes))}
    got = {k: v.shape for k, v in tree_leaves(variables)}
    assert got == want
    assert all(np.abs(v).min() > 0 for _, v in tree_leaves(variables))


def test_evaler_folds_train_form_weights():
    """Evaler.init_model(folded=False) serves the same boxes as folding by
    hand with the JAX fold and passing folded=True."""
    specs = build_model(TINY_GRAPH, nc=NC).specs
    variables = random_train_variables(specs, seed=9)
    imgs = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    a, b = Evaler(half=False), Evaler(half=False)
    a.init_model(TINY_GRAPH, variables, nc=NC, folded=False)
    b.init_model(TINY_GRAPH, jax.tree.map(np.asarray, jax_fold_variables(specs, variables)),
                 nc=NC, folded=True)
    got, want = a.predict(imgs), b.predict(imgs)
    assert int(want["valid"].sum()) > 0
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-4, rtol=1e-4)
