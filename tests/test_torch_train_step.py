"""The port's train step against JAX make_train_step on the same bridged
state (TINY_GRAPH at 128 px, every leaf nonzero, f32 on the CPU): an
accumulate-only step, an apply step with ATSS, an apply step with TAL, at
warmup_schedule's values. After each step: params, momentum, EMA params and
stats, BN running stats, `updates` and the loss components.

Tolerance per leaf: max|port - jax| <= 2e-4 * s, with s the leaf's largest
magnitude, floored at 1e-2 of the tree's; loss components rtol 1e-4. The two
differ in the order of f32 sums only, but a train step on 2 images is
ill-conditioned (train-mode BN over few values per channel at P5, a loss
near 100 from random nonzero heads): at 64 px, against an f64 run of the
same first step, both packages' gradients sit up to 7e-5 of the leaf's
magnitude away (JAX 7e-5, the port 4e-5), so 128 px (32 values per channel
at P5) is the size held here; and leaves whose true gradient is 0 (the bias
of a BN that another train-mode BN follows) carry rounding noise only,
hence the floor."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from helpers import TINY_GRAPH
from mafyolo_tpu.core.flatten import make_flatteners
from mafyolo_tpu.core.train_state import flatten_into_state
from mafyolo_tpu.core.train_state import init_train_state as jax_init_train_state
from mafyolo_tpu.core.train_state import make_train_step as jax_make_train_step
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.solver.build import build_lr_fn as jax_build_lr_fn
from mafyolo_tpu.solver.build import warmup_schedule as jax_warmup_schedule
from mafyolo_tpu_torch.core.engine import Schedule
from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from mafyolo_tpu_torch.utils.config import Config
from torch_common import to_jax, tree_leaves

NC, IMG, WD = 4, 128, 5e-4


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


def test_three_train_steps_match_jax():
    specs = build_model(TINY_GRAPH, nc=NC).specs
    variables = random_train_variables(specs, seed=12)
    imgs, targets = _batch()

    jmodel = jax_build_model(TINY_GRAPH, nc=NC)
    pf, sf, _ = make_flatteners(jmodel, IMG)
    jstate = jax_init_train_state(jmodel, jax.random.PRNGKey(0), IMG)
    jv = to_jax(variables)
    jstate = flatten_into_state(jmodel, IMG, jstate, params=jv["params"], ema=jv)
    jstate["batch_stats"] = jv["batch_stats"]
    jstep = jax_make_train_step(jmodel, num_classes=NC, img_size=IMG, weight_decay=WD)

    model = build_model(TINY_GRAPH, nc=NC)
    model.load_state_dict(train_variables_to_state_dict(variables))
    state = init_train_state(model, weight_decay=WD)
    step = make_train_step(num_classes=NC, img_size=IMG)
    names = {id(p): n for n, p in model.named_parameters()}

    lf = jax_build_lr_fn("linear", 0.01, 300)
    for curr_step, do_apply, use_atss in ((1400, False, True), (1401, True, True),
                                          (1402, True, False)):
        s = jax_warmup_schedule(curr_step, 1000, 0, lf, 0.01, 2, 0.1, 0.8, 0.937)
        lrs = (s["lr_bnw"], s["lr_weight"], s["lr_bias"], s["momentum"])
        jstate, jmet = jstep(jstate, jnp.asarray(imgs), jnp.asarray(targets),
                             *map(jnp.float32, lrs), jnp.bool_(do_apply), use_atss)
        met = step(state, torch.from_numpy(imgs), torch.from_numpy(targets), *lrs,
                   do_apply, use_atss)
        for k in ("loss", "iou", "dfl", "cls"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4)
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
            assert len(mom) == len(names)
            _assert_tree_close(state_dict_to_train_variables(mom)["params"],
                               pf.unflatten(jstate["mom"]), "momentum")
    assert state.updates == 2 and state.rng_step == 3
    # the apply steps moved every conv kernel (weight decay at least), and
    # the EMA followed
    moved = dict(tree_leaves(state_dict_to_train_variables(model.state_dict())["params"]))
    ema = dict(tree_leaves(state_dict_to_train_variables(state.ema.state_dict())["params"]))
    for k, v in tree_leaves(variables["params"]):
        if k.endswith("kernel"):
            assert not np.array_equal(moved[k], v) and not np.array_equal(ema[k], v), k


def test_accumulate_only_step_moves_only_bn_stats():
    specs = build_model(TINY_GRAPH, nc=NC).specs
    variables = random_train_variables(specs, seed=13)
    model = build_model(TINY_GRAPH, nc=NC)
    model.load_state_dict(train_variables_to_state_dict(variables))
    state = init_train_state(model, weight_decay=WD)
    imgs, targets = _batch()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ema_before = {k: v.clone() for k, v in state.ema.state_dict().items()}
    make_train_step(num_classes=NC, img_size=IMG)(
        state, torch.from_numpy(imgs), torch.from_numpy(targets), 0.01, 0.01, 0.01, 0.9,
        False, True)
    for k, v in model.state_dict().items():
        same = torch.equal(v, before[k])
        assert same != k.endswith(("running_mean", "running_var")), k
    for k, v in state.ema.state_dict().items():
        assert torch.equal(v, ema_before[k]), k
    assert state.updates == 0 and state.rng_step == 1 and not state.optimizer.state
    assert all(p.grad is not None for p in model.parameters())


def test_engine_schedule_matches_jax_loop():
    """The Trainer's Schedule.plan: its (do_apply, accumulate, lrs) sequence
    equals the JAX loop's (engine.py:305-312) over steps that cross the end
    of warm-up, for accumulate 2 (bs 32) and 8 (bs 8)."""
    cfg = Config.fromfile("configs/maf_yolo_n.py")
    solver = cfg.solver
    for bs, max_stepnum in ((32, 300), (8, 400)):
        tr = Schedule(solver, batch_size=bs, epochs=300, max_stepnum=max_stepnum)
        accumulate = max(1, round(64 / bs))
        lr0 = solver["lr0"] * bs / 32
        lf = jax_build_lr_fn(solver["lr_scheduler"], solver["lrf"], 300)
        warmup = max(round(solver["warmup_epochs"] * max_stepnum), 1000)
        assert tr.weight_decay == solver["weight_decay"] * bs * accumulate / 64
        assert tr.lr0 == lr0 and tr.warmup_stepnum == warmup
        last_opt_step, seq, want_seq = -1, [], []
        for epoch in (2, 3, 4):
            for step in range(max_stepnum):
                curr = step + max_stepnum * epoch
                s = jax_warmup_schedule(curr, warmup, epoch, lf, lr0, bs,
                                        solver["warmup_bias_lr"],
                                        solver["warmup_momentum"], solver["momentum"])
                do_apply = (curr - last_opt_step) >= s["accumulate"]
                if do_apply:
                    last_opt_step = curr
                want_seq.append((do_apply, s))
                seq.append(tr.plan(step, epoch)[::-1])
        assert seq == want_seq
        assert any(a for a, _ in seq) and not all(a for a, _ in seq)
