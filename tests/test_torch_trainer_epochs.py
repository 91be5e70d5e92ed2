"""The port's Trainer against the JAX Trainer over epochs 0-3, f32 on the
CPU: across the ATSS -> TAL switch (configs/maf_yolo_n.py: atss_warmup_epoch
3), through warm-up and the EMA's ramp.

The run, as tests/test_torch_trainer.py's: `make_synth_dataset` (8 train
images of 72-119 px, 3 classes) at 128 px, bs 4 (2 steps an epoch, each an
apply step in warm-up), host augmentation with the config's hyps and one
loader worker (bit-equal batches, tests/test_torch_augment.py), TINY_GRAPH,
the same `--pretrained` weights on both sides
(torch_common.prior_head_weights). Both train epochs 0-3 through
train_one_epoch; every step's loss is recorded on both sides.

Tolerances, set at about 3x what this run measures (f32 sums in another
order, on bit-equal batches; step 1's bias lr of 0.1 carries them on,
tests/test_torch_trainer.py says how): each step's loss and its parts within
rtol 5e-4 (measured 1.2e-4 at most, at the second TAL step;
1.6e-5 at most over the six ATSS steps); after epoch 3 every leaf within
t * s, s the leaf's largest magnitude floored at 1e-2 of the tree's, t =
3e-3 for params, EMA and BN statistics (measured 8.2e-4, 8.1e-4 and 1.1e-4)
and 3e-2 for the momentum, whose leaves are the last steps' gradients
(measured 9.9e-3). `updates` equal."""
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from helpers import TINY_GRAPH
from mafyolo_tpu.core.engine import Trainer as JaxTrainer
from mafyolo_tpu.parallel.mesh import make_mesh
from mafyolo_tpu.utils.config import Config as JaxConfig
from mafyolo_tpu_torch.core.engine import Trainer
from mafyolo_tpu_torch.utils.config import Config
from mafyolo_tpu_torch.utils.events import load_yaml
from tests.helpers import make_synth_dataset
from torch_common import prior_head_weights, tree_leaves

NC, IMG, EPOCHS = 3, 128, 4
LOSS_RTOL = 5e-4
STATE_TOL, MOMENTUM_TOL = 3e-3, 3e-2


def _args(save_dir, pretrained):
    return SimpleNamespace(
        img_size=IMG, batch_size=4, epochs=EPOCHS, workers=1, seed=0, save_dir=save_dir,
        resume=None, pretrained=pretrained, eval_interval=99, heavy_eval_range=0,
        stop_aug_last_n_epoch=0, max_labels=16, bf16=0, save_interval=99, remat=0,
        device_aug=False, simota=False, distill=False, tensorboard=False)


def _assert_tree_close(got, want, what, tol):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys(), what
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-2 * top)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_epochs")
    data = load_yaml(make_synth_dataset(root / "ds", n_images=8, img_size=96, nc=NC, seed=4))
    jcfg, cfg = JaxConfig.fromfile("configs/maf_yolo_n.py"), Config.fromfile(
        "configs/maf_yolo_n.py")
    for c in (jcfg, cfg):
        c.model.graph = TINY_GRAPH
    pre = str(root / "pre.npck")
    with open(pre, "wb") as f:
        pickle.dump({"model": prior_head_weights(TINY_GRAPH, NC)}, f)

    jtr = JaxTrainer(_args(str(root / "jax"), pre), jcfg, data, mesh=make_mesh(1))
    tr = Trainer(_args(str(root / "port"), pre), cfg, data, device="cpu")
    losses, atss = {"jax": [], "port": []}, {"jax": [], "port": []}
    jstep, pstep = jtr.train_step, tr.train_step

    def jax_recorded(state, *a):
        state, met = jstep(state, *a)
        losses["jax"].append({k: float(v) for k, v in met.items()})
        atss["jax"].append(bool(a[7]))
        return state, met

    def port_recorded(*a, **kw):
        met = pstep(*a, **kw)
        losses["port"].append({k: float(v) for k, v in met.items()})
        atss["port"].append(bool(a[8]))
        return met

    jtr.train_step, tr.train_step = jax_recorded, port_recorded
    for epoch in range(EPOCHS):
        jtr.train_one_epoch(epoch)
        tr.train_one_epoch(epoch)
    return SimpleNamespace(jtr=jtr, tr=tr, losses=losses, atss=atss)


def test_every_step_loss_matches_jax_across_the_tal_switch(run):
    jtr, tr, losses = run.jtr, run.tr, run.losses
    assert tr.max_stepnum == jtr.max_stepnum == 2
    assert tr.warmup_epoch_loss == jtr.warmup_epoch_loss == 3
    assert len(losses["port"]) == len(losses["jax"]) == 2 * EPOCHS
    for i, (got, want) in enumerate(zip(losses["port"], losses["jax"])):
        assert got.keys() == want.keys(), i
        for k, w in want.items():
            assert np.isfinite(got[k]), (i, k)
            np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
    # ATSS for epochs 0-2, TAL at epoch 3, on both sides
    assert run.atss["port"] == run.atss["jax"] == [True] * 6 + [False] * 2


def test_state_after_epoch_3_matches_jax(run):
    jtr, tr = run.jtr, run.tr
    assert tr.state.updates == int(jtr.state["updates"]) == 2 * EPOCHS
    ours = tr.checkpoint(EPOCHS - 1)
    _assert_tree_close(ours["model"]["params"], jtr._pf.unflatten(jtr.state["params"]),
                       "params", STATE_TOL)
    _assert_tree_close(ours["model"]["batch_stats"], jtr.state["batch_stats"], "batch_stats",
                       STATE_TOL)
    _assert_tree_close(ours["opt"], jtr._pf.unflatten(jtr.state["mom"]), "momentum",
                       MOMENTUM_TOL)
    _assert_tree_close(ours["ema"]["params"], jtr._pf.unflatten(jtr.state["ema"]["params"]),
                       "ema params", STATE_TOL)
    _assert_tree_close(ours["ema"]["batch_stats"],
                       jtr._sf.unflatten(jtr.state["ema"]["batch_stats"]), "ema stats",
                       STATE_TOL)
