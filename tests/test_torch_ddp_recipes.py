"""Data parallel (parallel/ddp.py) under the training recipes, on the CPU:
two gloo ranks (init_method file:// under tmp_path) run the train step on
the two halves of a global batch of 4 at 64 px, against one process on the
whole batch. Every global-batch quantity a recipe adds is the global
batch's on each rank: Wise-IoU's batch mean (the masked IoU loss's sum and
count, all-reduced), SimOTA's positive count, distillation's normalisers
(target_scores_sum, the DFL term's positive count and KL sum, the feature
term's batch size). Rank r holds rows r::2 (the loader's stride).

The recipes: 'wiou' (TINY_GRAPH, iou_type 'wiou'), 'simota' (TINY_GRAPH with
Head_simota heads) and 'distill' (a teacher of TINY_GRAPH from another
seed, the feature term on), each over an apply step, an accumulate-only
step and an apply step (TAL). The port's model in f64 on every side, as
tests/test_torch_ddp.py runs it (the losses stay f32); each rank's state
against the one process's, elementwise: loss components rtol 1e-5, each
step's move of Wise-IoU's mean (from 0.3, where a step moves it by 6e-5)
rtol 5e-3, params, EMA and BN running statistics rtol 1e-5 / atol
1e-6, momentum rtol 1e-4 / atol 2e-5 (test_torch_ddp.py's tolerances). The
two ranks' states are equal bit for bit."""
import copy
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import TINY_GRAPH
from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.parallel import ddp
from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from torch_common import tree_leaves

NC, IMG, BATCH, WORLD, WD, LR, MOM = 4, 64, 4, 2, 5e-4, 0.01, 0.9
MEAN0 = 0.3      # Wise-IoU's mean before the plan: its steps then move it by ~6e-5
PLAN = [(True, False), (False, False), (True, False)]
SIMOTA_GRAPH = copy.deepcopy(TINY_GRAPH)
SIMOTA_GRAPH["effidehead"] = [[3, 1, "Head_simota", [32, 0]], [4, 1, "Head_simota", [32, 0]],
                              [5, 1, "Head_simota", [32, 0]], [[6, 7, 8], 1, "Out", []]]
RECIPES = {"wiou": (TINY_GRAPH, dict(iou_type="wiou")),
           "simota": (SIMOTA_GRAPH, dict(loss_type="simota", iou_type="ciou")),
           "distill": (TINY_GRAPH, dict(loss_type="distill", distill_feat=True))}


def _batch():
    """Rank 0's rows (0, 2) hold two large boxes each, rank 1's (1, 3) three
    small ones: the ranks' own batch means and positive counts differ from
    the global batch's."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 255, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    targets = np.full((BATCH, 4, 5), -1, np.float32)
    for i in range(BATCH):
        if i % 2 == 0:
            targets[i, 0] = [rng.integers(NC), 0.5, 0.5, 0.7, 0.6]
            targets[i, 1] = [rng.integers(NC), 0.35, 0.4, 0.5, 0.6]
        else:
            for j, (x, y) in enumerate(((0.2, 0.25), (0.7, 0.3), (0.5, 0.75))):
                targets[i, j] = [rng.integers(NC), x, y, 0.15, 0.2]
    return imgs, targets


def _run(name, imgs, targets):
    """The port's f64 steps of PLAN under recipe `name` -> metrics, state
    (numpy) and Wise-IoU's mean after each step."""
    graph, kw = RECIPES[name]
    model = build_model(graph, nc=NC)
    model.load_state_dict(train_variables_to_state_dict(
        random_train_variables(model.specs, seed=12)))
    model.double()
    kw = dict(kw)
    if name == "distill":
        teacher = build_model(graph, nc=NC)
        teacher.load_state_dict(train_variables_to_state_dict(
            random_train_variables(teacher.specs, seed=21)))
        kw["teacher"] = teacher.double()
    state = init_train_state(model, weight_decay=WD)
    state.wiou_mean.fill_(MEAN0)
    step = make_train_step(num_classes=NC, img_size=IMG, **kw)
    metrics, means = [], [float(state.wiou_mean)]
    for do_apply, use_atss in PLAN:
        met = step(state, torch.from_numpy(imgs), torch.from_numpy(targets), LR, LR, LR, MOM,
                   do_apply, use_atss, epoch_num=20)
        metrics.append({k: float(v) for k, v in met.items()})
        means.append(float(state.wiou_mean))
    names = {id(p): n for n, p in model.named_parameters()}
    mom = {names[id(p)]: st["momentum_buffer"] for p, st in state.optimizer.state.items()}
    return {"metrics": metrics, "means": means,
            "model": state_dict_to_train_variables(model.state_dict()),
            "ema": state_dict_to_train_variables(state.ema.state_dict()),
            "mom": state_dict_to_train_variables(mom)["params"], "updates": state.updates}


def _rank(rank, init_method, out_dir, imgs, targets):
    torch.set_num_threads(1)
    ddp.init_distributed("cpu", init_method=init_method, rank=rank, world=WORLD)
    try:
        out = {name: _run(name, imgs[rank::WORLD], targets[rank::WORLD]) for name in RECIPES}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_recipes")
    imgs, targets = _batch()
    ctx = torch.multiprocessing.spawn(
        _rank, args=(f"file://{tmp}/rendezvous", str(tmp), imgs, targets), nprocs=WORLD,
        join=False)
    one = {name: _run(name, imgs, targets) for name in RECIPES}
    while not ctx.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, one


def _close(got, want, what, rtol, atol):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", list(RECIPES))
def test_two_ranks_match_one_process(runs, name):
    ranks, one = runs
    want = one[name]
    for key in ("model", "ema", "mom"):
        for (k, a), (_, b) in zip(tree_leaves(ranks[0][name][key]),
                                  tree_leaves(ranks[1][name][key])):
            np.testing.assert_array_equal(a, b, err_msg=f"ranks differ: {key} {k}")
    got = ranks[0][name]
    assert got["updates"] == want["updates"] == 2
    for m, w in zip(got["metrics"], want["metrics"]):
        assert m.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(m[k], w[k], rtol=1e-5, err_msg=k)
    # each step's move of the mean (an f32 of 0.3 holds it to 5e-4)
    np.testing.assert_allclose(np.diff(got["means"]), np.diff(want["means"]), rtol=5e-3)
    assert (want["means"][-1] != want["means"][0]) == (name == "wiou")
    for key in ("model", "ema"):
        _close(got[key], want[key], key, 1e-5, 1e-6)
    _close(got["mom"], want["mom"], "momentum", 1e-4, 2e-5)
