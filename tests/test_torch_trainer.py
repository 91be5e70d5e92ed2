"""The port's Trainer against the JAX Trainer, f32 on the CPU.

The run: `make_synth_dataset` (8 train images of 72-119 px, 3 classes) at
128 px, bs 4, host augmentation with configs/maf_yolo_n.py's hyps (mosaic,
dy_mixup; copy_paste finds no segments), one loader worker (the mosaic cache
is filled in sample order), TINY_GRAPH, and the same weights as
`--pretrained` on both sides: torch_common.prior_head_weights (every leaf
nonzero, the cls preds scoring near the prior 0.01). Both train epoch 0 (two steps in warm-up, each an apply step: bias lr
0.1, weight lr 0 then 1.25e-6) and save. The JAX Trainer is built once here.

Tolerances per leaf after the epoch, max|port - jax| <= t * s, s the
leaf's largest magnitude floored at 1e-2 of the tree's (the train-step
rule, tests/test_torch_train_step.py): t = 2e-4 for params, EMA and BN
stats, 5e-3 for the momentum, whose leaves are the last step's gradients
(measured 2.8e-5 and 1.2e-3). The two differ in the order of f32 sums only,
on bit-equal batches (tests/test_torch_augment.py) and with losses equal to
1e-6 at step 0; but step 0's bias lr of 0.1 carries those differences into
step 1, where the BN biases of layers 0-3 (whose gradients nearly cancel)
meet them. With random_train_variables' own cls preds (a cls loss of 146,
an operating point no run visits) the same order differences reach 3.5% of
a BN bias's momentum. `updates` equal. A resumed state is held bit for
bit."""
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from helpers import TINY_GRAPH
from mafyolo_tpu.core.engine import Trainer as JaxTrainer
from mafyolo_tpu.parallel.mesh import make_mesh
from mafyolo_tpu.utils import checkpoint as jax_ckpt
from mafyolo_tpu.utils.config import Config as JaxConfig
from mafyolo_tpu_torch.core.engine import Trainer
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.utils import checkpoint as ckpt
from mafyolo_tpu_torch.utils.bridge import random_train_variables, state_dict_to_train_variables
from mafyolo_tpu_torch.utils.config import Config
from mafyolo_tpu_torch.utils.events import load_yaml
from tests.helpers import make_synth_dataset
from torch_common import prior_head_weights, tree_leaves

NC, IMG = 3, 128


class _Args:
    img_size = IMG
    batch_size = 4
    epochs = 2
    workers = 1
    seed = 0
    save_dir = None
    resume = None
    pretrained = None
    eval_interval = 99
    heavy_eval_range = 0
    stop_aug_last_n_epoch = 0
    max_labels = 16
    bf16 = 0
    save_interval = 99
    remat = 0
    device_aug = False
    simota = False
    distill = False
    tensorboard = False


def _args(**kw):
    a = _Args()
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def _configs():
    cfgs = JaxConfig.fromfile("configs/maf_yolo_n.py"), Config.fromfile("configs/maf_yolo_n.py")
    for c in cfgs:
        c.model.graph = TINY_GRAPH
    return cfgs


def _assert_tree_close(got, want, what, tol=2e-4):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys(), what
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-2 * top)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what}: {k}")


def _assert_tree_equal(got, want, what):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w, np.float32), err_msg=f"{what}: {k}")


def _port_state(tr):
    """The port trainer's state in the checkpoint layout (numpy)."""
    return tr.checkpoint(-1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    data = load_yaml(make_synth_dataset(root / "ds", n_images=8, img_size=96, nc=NC, seed=4))
    jcfg, cfg = _configs()
    variables = prior_head_weights(TINY_GRAPH, NC)
    pre = str(root / "pre.npck")
    with open(pre, "wb") as f:
        pickle.dump({"model": variables}, f)

    jtr = JaxTrainer(_args(save_dir=str(root / "jax"), pretrained=pre), jcfg, data,
                     mesh=make_mesh(1))
    jtr.train_one_epoch(0)
    jtr.eval_and_save(0)
    tr = Trainer(_args(save_dir=str(root / "port"), pretrained=pre), cfg, data, device="cpu")
    tr.train_one_epoch(0)
    tr.eval_and_save(0)
    return SimpleNamespace(root=root, data=data, cfg=cfg, jcfg=jcfg, pre=pre, jtr=jtr, tr=tr)


def test_first_epoch_matches_jax(run):
    jtr, tr = run.jtr, run.tr
    assert tr.max_stepnum == jtr.max_stepnum == 2
    assert tr.state.updates == int(jtr.state["updates"]) == 2
    assert tr.state.rng_step == int(jtr.state["rng_step"]) == 2
    ours = _port_state(tr)
    _assert_tree_close(ours["model"]["params"], jtr._pf.unflatten(jtr.state["params"]),
                       "params")
    _assert_tree_close(ours["model"]["batch_stats"], jtr.state["batch_stats"], "batch_stats")
    _assert_tree_close(ours["opt"], jtr._pf.unflatten(jtr.state["mom"]), "momentum", 5e-3)
    _assert_tree_close(ours["ema"]["params"], jtr._pf.unflatten(jtr.state["ema"]["params"]),
                       "ema params")
    _assert_tree_close(ours["ema"]["batch_stats"],
                       jtr._sf.unflatten(jtr.state["ema"]["batch_stats"]), "ema stats")
    # the epoch moved the biases (lr 0.1; the weight lr is 0, then 1.25e-6),
    # but those of a BN that another train-mode BN follows (gradient 0)
    start = dict(tree_leaves(jax_ckpt.load_checkpoint(run.pre)["model"]["params"]))
    moved = dict(tree_leaves(ours["model"]["params"]))
    biases = [k for k in start if k.endswith("bias")]
    n_moved = sum(not np.array_equal(moved[k], start[k]) for k in biases)
    assert len(biases) == 60 and n_moved >= 30, n_moved


def test_checkpoint_layout_matches_jax(run):
    """last_ckpt.npck: the same keys, tree paths, shapes and dtypes."""
    mine = ckpt.load_checkpoint(str(run.root / "port" / "last_ckpt.npck"))
    theirs = jax_ckpt.load_checkpoint(str(run.root / "jax" / "last_ckpt.npck"))
    assert mine.keys() == theirs.keys()
    for key in ("model", "ema", "opt"):
        a, b = dict(tree_leaves(mine[key])), dict(tree_leaves(theirs[key]))
        assert a.keys() == b.keys(), key
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (key, k)
    for key in ("updates", "wiou_mean", "epoch"):
        assert mine[key] == theirs[key], key
    assert mine["meta"] == theirs["meta"]


def test_port_resumes_jax_checkpoint(run):
    """The port's Trainer resumed from the JAX run's last_ckpt.npck holds
    its params, BN stats, momentum, EMA and updates bit for bit, and starts
    at the next epoch."""
    path = str(run.root / "jax" / "last_ckpt.npck")
    tr = Trainer(_args(save_dir=str(run.root / "port_resumed"), resume=path), run.cfg,
                 run.data, device="cpu")
    want = jax_ckpt.load_checkpoint(path)
    got = _port_state(tr)
    assert tr.start_epoch == 1 and tr.state.updates == want["updates"] == 2
    for key in ("model", "ema"):
        _assert_tree_equal(got[key], want[key], key)
    _assert_tree_equal(got["opt"], want["opt"], "momentum")


def test_should_eval_matches_jax():
    for epochs, interval, heavy in ((300, 20, 50), (10, 20, 0), (4, 20, 50), (7, 3, 2)):
        ns = SimpleNamespace(epochs=epochs, eval_interval=interval, heavy_eval_range=heavy)
        assert [Trainer._should_eval(ns, e) for e in range(epochs)] == \
            [JaxTrainer._should_eval(ns, e) for e in range(epochs)]


def test_prepare_for_steps_at_the_tail_matches_jax(run):
    """At epoch epochs - stop_aug_last_n_epoch, device mosaic goes off (the
    step is rebuilt) and the loader is rebuilt with host augmentation but
    no mosaic or mixup, in device-aug mode too; its batches equal the JAX
    trainer's. One epoch earlier nothing changes."""
    tr = Trainer(_args(save_dir=str(run.root / "tail"), device_aug=True, epochs=5,
                       stop_aug_last_n_epoch=2), run.cfg, run.data, device="cpu")
    step0, loader0 = tr.train_step, tr.train_loader
    rebuilt = []
    jns = SimpleNamespace(
        epochs=5, stop_aug_last_n_epoch=2, device_aug=dict(tr.device_aug), cfg=run.jcfg,
        img_size=IMG, batch_size=4,
        args=tr.args, data_dict=run.data, train_loader=tr.train_loader,
        _mk_train_step=lambda d: rebuilt.append(d) or "step")
    for epoch in (2, 3):
        tr.prepare_for_steps(epoch)
        JaxTrainer.prepare_for_steps(jns, epoch)
        assert tr.device_aug == jns.device_aug and tr.train_loader.epoch == epoch
        if epoch == 2:
            assert tr.train_step is step0 and tr.train_loader is loader0
    assert tr.device_aug["mosaic"] == 0.0 and rebuilt == [tr.device_aug]
    assert tr.train_step is not step0
    ds, jds = tr.train_dataset, jns.train_dataset
    assert ds.augment and jds.augment and ds.hyp == jds.hyp
    assert ds.hyp["mosaic"] == ds.hyp["mixup"] == ds.hyp["dy_mixup"] == 0.0
    assert len(tr.train_loader) == len(jns.train_loader) == 2     # drop_last
    for (a, la, _), (b, lb, _) in zip(tr.train_loader, jns.train_loader):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_checkpoint_helpers_match_jax(run, tmp_path):
    """strip_checkpoint, load_shape_matched and find_latest_checkpoint
    against the JAX ones."""
    src = run.root / "port" / "last_ckpt.npck"
    for name, mod in (("mine", ckpt), ("theirs", jax_ckpt)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "last_ckpt.npck").write_bytes(src.read_bytes())
        mod.strip_checkpoint(str(tmp_path / name / "last_ckpt.npck"))
    mine = ckpt.load_checkpoint(str(tmp_path / "mine" / "last_ckpt.npck"))
    theirs = ckpt.load_checkpoint(str(tmp_path / "theirs" / "last_ckpt.npck"))
    assert mine.keys() == theirs.keys() and "opt" not in mine and mine["ema"] is None
    assert mine["updates"] == theirs["updates"] == 0
    for k, v in tree_leaves(theirs["model"]):
        got = dict(tree_leaves(mine["model"]))[k]
        assert got.dtype == v.dtype == np.float16
        np.testing.assert_array_equal(got, v)

    params = state_dict_to_train_variables(
        dict(build_model(TINY_GRAPH, nc=NC).named_parameters()))["params"]
    pre = random_train_variables(build_model(TINY_GRAPH, nc=NC + 2).specs, seed=1)["params"]
    got = ckpt.load_shape_matched(params, pre)
    want = jax_ckpt.load_shape_matched(params, pre)
    kept = 0
    for (k, a), (k2, b) in zip(tree_leaves(got), tree_leaves(want)):
        assert k == k2
        np.testing.assert_array_equal(a, np.asarray(b))
        kept += not np.array_equal(a, dict(tree_leaves(pre))[k]) if a.shape == \
            dict(tree_leaves(pre))[k].shape else 1
    assert kept > 0          # the cls preds of nc + 2 classes do not match

    assert ckpt.find_latest_checkpoint(str(tmp_path / "none")) is None
    assert ckpt.find_latest_checkpoint(str(run.root)) == \
        jax_ckpt.find_latest_checkpoint(str(run.root))


def test_unported_options_raise(run):
    for kw, cfg_key in (({"simota": True}, None), ({"distill": True}, None),
                        ({}, ("training_mode", "repopt")),
                        ({}, ("build_type", "office")), ({"remat": True}, None)):
        _, cfg = _configs()
        if cfg_key == ("training_mode", "repopt"):
            cfg.training_mode = "repopt"
        elif cfg_key:
            cfg.model.build_type = "office"
        match = "rematerialization" if kw.get("remat") else "remaining training variants"
        with pytest.raises(NotImplementedError, match=match):
            Trainer(_args(save_dir=str(run.root / "x"), **kw), cfg, run.data, device="cpu")
    assert torch.device("cuda") == torch.device(
        Trainer.__init__.__kwdefaults__["device"])


def test_profile_traces_steps_2_to_7(run):
    """--profile: a torch.profiler trace of steps 2-7 of the first epoch in
    save_dir/profile (here 4 steps of bs 2: the trace ends with the epoch)."""
    tr = Trainer(_args(save_dir=str(run.root / "profiled"), batch_size=2, profile=True),
                 run.cfg, run.data, device="cpu")
    assert tr.max_stepnum == 4
    tr.train_one_epoch(0)
    assert (run.root / "profiled" / "profile" / "trace.json").stat().st_size > 0
    assert tr.state.updates > 0
