"""MAF-YOLO-S and -M train forms in the port against the JAX package on the
CPU at 64 px, on the same random train variables (every leaf nonzero): the
train-mode forward and the updated BN running statistics, the fold to the
deploy form (leaf for leaf against the JAX fold, and the folded model
against the train form in eval mode), and one S train step against JAX's
make_train_step (M's step runs on the card: chip_smoke.py's sm_train).

The train-mode forward is compared in f64 in both packages (jax.enable_x64,
the flax model built with dtype float64): at 64 px on 2 images every BN
normalizes 8 values a channel at P5, and in f32 S's and M's deeper stacks
amplify rounding past N's tolerance (tests/test_torch_train_model.py):
against the port's own f64 run the port's f32 outputs sit 0.014 (S) and
0.12 (M) away, JAX's 0.036 and 0.37. In f64 the two agree to 6e-8 in the
outputs and 1.2e-7 in the statistics, held at 1e-6. The folds are held
at 1e-6 relative and the folded model at 1e-4, as N's.

The S step (f32, 128 px, 2 images: 32 values a channel at P5) is held in
the form tests/test_torch_train_step.py holds TINY_GRAPH's: each leaf of
params, momentum, EMA and BN statistics within a share of its largest
magnitude (floored at 1e-2 of the tree's), the loss components rtol 1e-4.
The share is 5e-3, not TINY_GRAPH's 2e-4: S's deeper train-mode stack
puts the two packages' f32 steps 7.2e-4 apart in params and EMA, 1.9e-3 in
momentum (a DW kernel's raw gradient) and 7.3e-5 in the statistics. Its
cls preds start at the prior (torch_common.prior_head_weights): random
heads put the loss near 200 and make the f32 gradients worse still."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.core.flatten import make_flatteners
from mafyolo_tpu.core.train_state import make_train_step as jax_make_train_step
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.reparam import fold_variables as jax_fold_variables
from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.reparam import fold_variables
from mafyolo_tpu_torch.utils.bridge import (folded_to_state_dict, random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from torch_common import prior_head_weights, to_jax, tree_leaves

NC, IMG = 7, 64
GRAPHS = ("maf-yolo-s", "maf-yolo-m")


def _port(graph, variables, seed_img=1, img=IMG, b=2):
    model = build_model(graph, nc=NC)
    model.load_state_dict(train_variables_to_state_dict(variables))
    x = np.random.default_rng(seed_img).uniform(0, 1, (b, img, img, 3)).astype(np.float32)
    return model, x


@pytest.mark.parametrize("graph", GRAPHS)
def test_train_forward_and_bn_stats_match_jax(graph):
    variables = random_train_variables(build_model(graph, nc=NC).specs, seed=4)
    model, x = _port(graph, variables)
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, mut = jax.tree.map(np.asarray, jax.jit(lambda v, a: jax_build_model(
            graph, nc=NC, dtype=jnp.float64).apply(v, a, train=True, mutable=["batch_stats"]))(
                f64, jnp.asarray(x, jnp.float64)))
    got = model.double().train()(torch.from_numpy(x).double())
    for g_level, w_level in zip(got, want):
        for g, w in zip(g_level, w_level):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-6, rtol=0)
    assert float(want[0][1].std()) > 1e-3
    stats = dict(tree_leaves(state_dict_to_train_variables(model.state_dict())["batch_stats"]))
    want_stats = dict(tree_leaves(mut["batch_stats"]))
    assert stats.keys() == want_stats.keys() and len(stats) > 100
    old = dict(tree_leaves(variables["batch_stats"]))
    for k, w in want_stats.items():
        assert not np.allclose(w, old[k])          # the step moved every stat
        np.testing.assert_allclose(stats[k], w, atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("graph", GRAPHS)
def test_fold_matches_jax_fold_and_train_eval(graph):
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


def _assert_tree_close(got, want, what):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys(), what
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-2 * top)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=5e-3 * scale, err_msg=f"{what}: {k}")


def test_s_train_step_matches_jax():
    """One apply step of S with ATSS at warm-up's lrs: params, momentum, EMA
    and BN statistics, updates and the loss components."""
    graph, img, wd = "maf-yolo-s", 128, 5e-4
    variables = prior_head_weights(graph, NC, seed=12)
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (2, img, img, 3), dtype=np.uint8)
    targets = np.zeros((2, 6, 5), np.float32)
    targets[..., 0] = -1
    targets[0, :3] = [[1, .3, .3, .3, .35], [3, .6, .55, .5, .4], [0, .8, .2, .2, .25]]
    targets[1, :2] = [[2, .5, .5, .8, .7], [6, .3, .7, .25, .2]]

    jmodel = jax_build_model(graph, nc=NC)
    pf, sf, _ = make_flatteners(jmodel, img)
    flat = pf.flatten(to_jax(variables["params"]))
    stats = to_jax(variables["batch_stats"])
    jstate = {"params": flat, "batch_stats": stats,
              "ema": {"params": flat, "batch_stats": sf.flatten(stats)},
              "mom": jnp.zeros_like(flat), "grad_acc": jnp.zeros_like(flat),
              "updates": jnp.zeros((), jnp.int32), "rng_step": jnp.zeros((), jnp.int32),
              "wiou_mean": jnp.ones((), jnp.float32)}
    jstep = jax_make_train_step(jmodel, num_classes=NC, img_size=img, weight_decay=wd)
    lrs = (0.01, 0.009, 0.08, 0.85)
    jstate, jmet = jstep(jstate, jnp.asarray(imgs), jnp.asarray(targets),
                         *map(jnp.float32, lrs), jnp.bool_(True), True)

    model = build_model(graph, nc=NC)
    model.load_state_dict(train_variables_to_state_dict(variables))
    state = init_train_state(model, weight_decay=wd)
    met = make_train_step(num_classes=NC, img_size=img)(
        state, torch.from_numpy(imgs), torch.from_numpy(targets), *lrs, True, True)
    for k in ("loss", "iou", "dfl", "cls"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4)
    assert state.updates == int(jstate["updates"]) == 1

    ours = state_dict_to_train_variables(model.state_dict())
    _assert_tree_close(ours["params"], pf.unflatten(jstate["params"]), "params")
    _assert_tree_close(ours["batch_stats"], jstate["batch_stats"], "batch_stats")
    ema = state_dict_to_train_variables(state.ema.state_dict())
    _assert_tree_close(ema["params"], pf.unflatten(jstate["ema"]["params"]), "ema params")
    _assert_tree_close(ema["batch_stats"], sf.unflatten(jstate["ema"]["batch_stats"]),
                       "ema stats")
    names = {id(p): n for n, p in model.named_parameters()}
    mom = {names[id(p)]: st["momentum_buffer"] for p, st in state.optimizer.state.items()}
    assert len(mom) == len(names)
    _assert_tree_close(state_dict_to_train_variables(mom)["params"],
                       pf.unflatten(jstate["mom"]), "momentum")
