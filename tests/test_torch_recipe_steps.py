"""The port's train step under each training recipe against JAX
make_train_step on the same bridged state: Wise-IoU (iou_type 'wiou', its
running mean threaded through the state), distillation (a teacher of the
same graph from another seed, the feature term on), SimOTA (the tiny graph
with Head_simota heads) and repopt (the plain graph, kernels re-initialized
and masked by repopt_prepare from the same scales and generator). TINY_GRAPH
at 128 px, every leaf nonzero, two steps each: an accumulate-only step,
then an apply step (TAL; distillation at epoch 150 of 300), at
warmup_schedule's values.

After each step: the loss components rtol 1e-4, Wise-IoU's mean rtol 1e-6,
`updates`; params, momentum, EMA params and stats and the BN running stats
per leaf within 2e-4 of the leaf's largest magnitude, floored at 1e-2 of
the tree's (tests/test_torch_train_step.py's tolerance, for the reasons its
docstring gives). f32 on both sides, but for repopt, which both packages
run in f64 (the port's model in double, JAX's flax model with dtype float64
under jax.enable_x64): in f32 one of layer 3's 8192 2x2 maxpool windows
holds two values within an f32 rounding of each other, the port's
rounding picks the other one than JAX's and f64's, and the gradient it
routes moves layer 2's input gradient by 0.17 of its scale (the port in f32
is then 9.4e-3 of a parameter's scale from its f64 step, JAX 2.2e-6; in f64
the two packages are 4.1e-7 apart).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TINY_GRAPH
from mafyolo_tpu.core.flatten import make_flatteners
from mafyolo_tpu.core.train_state import flatten_into_state
from mafyolo_tpu.core.train_state import init_train_state as jax_init_train_state
from mafyolo_tpu.core.train_state import make_train_step as jax_make_train_step
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.solver import repopt as JR
from mafyolo_tpu.solver.build import build_lr_fn as jax_build_lr_fn
from mafyolo_tpu.solver.build import warmup_schedule as jax_warmup_schedule
from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.solver import repopt as R
from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from torch_common import to_jax, tree_leaves

NC, IMG, WD, EPOCH = 4, 128, 5e-4, 150
SIMOTA_GRAPH = copy.deepcopy(TINY_GRAPH)
SIMOTA_GRAPH["effidehead"] = [[3, 1, "Head_simota", [32, 0]], [4, 1, "Head_simota", [32, 0]],
                              [5, 1, "Head_simota", [32, 0]], [[6, 7, 8], 1, "Out", []]]
RECIPES = ("wiou", "distill", "simota", "repopt")
F64 = ("repopt",)


def _assert_tree_close(got, want, what):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys(), what
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-2 * top)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"{what}: {k}")


def _batch():
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    t = np.zeros((2, 6, 5), np.float32)
    t[..., 0] = -1
    t[0, :3] = [[1, .3, .3, .3, .35], [3, .6, .55, .5, .4], [0, .8, .2, .2, .25]]
    t[1, :2] = [[2, .5, .5, .8, .7], [1, .3, .7, .25, .2]]
    return imgs, t


def _recipe(name):
    """-> (graph, plain_rep, the step kwargs both packages share)."""
    graph = SIMOTA_GRAPH if name == "simota" else TINY_GRAPH
    plain = name == "repopt"
    kw = {"wiou": dict(iou_type="wiou"), "simota": dict(loss_type="simota", iou_type="ciou"),
          "distill": dict(distill_feat=True, max_epoch=300), "repopt": {}}[name]
    return graph, plain, kw


@pytest.mark.parametrize("name", RECIPES)
def test_two_recipe_steps_match_jax(name):
    f64 = name in F64
    with jax.enable_x64(f64):
        _two_steps(name, f64)


def _two_steps(name, f64):
    graph, plain, kw = _recipe(name)
    jdtype = jnp.float64 if f64 else jnp.float32
    specs = build_model(graph, nc=NC, plain_rep=plain).specs
    variables = random_train_variables(specs, seed=12, plain_rep=plain)
    imgs, targets = _batch()

    model = build_model(graph, nc=NC, plain_rep=plain)
    model.load_state_dict(train_variables_to_state_dict(variables))
    jmodel = jax_build_model(graph, nc=NC, plain_rep=plain, dtype=jdtype)
    if f64:
        model.double()
    pf, sf, _ = make_flatteners(jmodel, IMG)
    params = to_jax(variables)["params"]
    port_kw, jax_kw = dict(kw), dict(kw)
    if name == "repopt":
        scales = R.random_scales_like(model, np.random.default_rng(3))
        port_kw["grad_mask"] = R.repopt_prepare(model, scales, np.random.default_rng(5))
        params, mask_tree = JR.repopt_prepare(params, JR.random_scales_like(
            params, np.random.default_rng(3)), np.random.default_rng(5))
        jax_kw["grad_mask"] = pf.flatten(mask_tree)
    if name == "distill":
        t_vars = random_train_variables(specs, seed=21)
        teacher = build_model(graph, nc=NC)
        teacher.load_state_dict(train_variables_to_state_dict(t_vars))
        port_kw.update(loss_type="distill", teacher=teacher)
        jax_kw.update(loss_type="distill", teacher=(jax_build_model(graph, nc=NC),
                                                    to_jax(t_vars)))

    jstate = jax_init_train_state(jmodel, jax.random.PRNGKey(0), IMG)
    jstate = flatten_into_state(jmodel, IMG, jstate, params=params,
                                ema={"params": params, "batch_stats": variables["batch_stats"]})
    jstate["batch_stats"] = jax.tree.map(lambda a: jnp.asarray(a, jdtype),
                                         to_jax(variables)["batch_stats"])
    jstep = jax_make_train_step(jmodel, num_classes=NC, img_size=IMG, weight_decay=WD, **jax_kw)
    state = init_train_state(model, weight_decay=WD)
    step = make_train_step(num_classes=NC, img_size=IMG, **port_kw)
    names = {id(p): n for n, p in model.named_parameters()}

    lf = jax_build_lr_fn("linear", 0.01, 300)
    for curr_step, do_apply in ((1400, False), (1401, True)):
        s = jax_warmup_schedule(curr_step, 1000, 0, lf, 0.01, 2, 0.1, 0.8, 0.937)
        lrs = (s["lr_bnw"], s["lr_weight"], s["lr_bias"], s["momentum"])
        jstate, jmet = jstep(jstate, jnp.asarray(imgs), jnp.asarray(targets),
                             *map(jnp.float32, lrs), jnp.bool_(do_apply), False,
                             jnp.float32(EPOCH))
        met = step(state, torch.from_numpy(imgs), torch.from_numpy(targets), *lrs, do_apply,
                   False, epoch_num=EPOCH)
        assert met.keys() == jmet.keys()
        for k in jmet:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(state.wiou_mean), float(jstate["wiou_mean"]), rtol=1e-6)
        assert state.updates == int(jstate["updates"])

        ours = state_dict_to_train_variables(model.state_dict())
        _assert_tree_close(ours["params"], pf.unflatten(jstate["params"]), "params")
        _assert_tree_close(ours["batch_stats"], jstate["batch_stats"], "batch_stats")
        ema = state_dict_to_train_variables(state.ema.state_dict())
        _assert_tree_close(ema["params"], pf.unflatten(jstate["ema"]["params"]), "ema params")
        _assert_tree_close(ema["batch_stats"], sf.unflatten(jstate["ema"]["batch_stats"]),
                           "ema stats")
        if state.updates:
            mom = {names[id(p)]: st["momentum_buffer"]
                   for p, st in state.optimizer.state.items()}
            _assert_tree_close(state_dict_to_train_variables(mom)["params"],
                               pf.unflatten(jstate["mom"]), "momentum")
    assert state.updates == 1 and state.rng_step == 2
    assert (float(state.wiou_mean) != 1.0) == (name == "wiou")
