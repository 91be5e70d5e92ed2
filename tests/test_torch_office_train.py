"""The YOLOv6 office graphs' train forms, train step and Trainer in the port
against the JAX package on the CPU.

Train forward and BN statistics of N, M and L at 64 px on 2 images, on the
same random train variables (every leaf nonzero), compared in f64 on both
sides (jax.enable_x64, the flax model built with dtype float64), as
tests/test_torch_train_sm.py does for S and M: in f32 the train-mode BN
over 8 values a channel at P5 makes the deep RepBlock and BepC3 stacks
ill-conditioned (measured at 64 px: the two packages' f32 outputs 1.3e-2
apart at P5, where the f64 ones agree to 1.2e-11). Held at 1e-6.

One office N step with TAL, then one with ATSS, against JAX's
make_train_step at 128 px, each an apply step at warm-up's lrs, the cls
preds at the prior (torch_common.prior_head_weights), in f64 on both sides
(JAX keeps its flat params, momentum and EMA in f32, and both losses are
f32), as tests/test_torch_ddp.py runs N: in f32 the train-mode backward
puts the two packages 2.2% of a momentum leaf apart (layer 0's BN biases,
whose gradients nearly cancel). TAL goes first: its top-k over predicted
scores and IoUs meets near-ties, and once the two states have moved apart
at all (ATSS first) one flipped tie put a momentum leaf 1.7% apart; ATSS
assigns from the anchors and boxes alone. The loss components (f32 sums)
are held at rtol 1e-4; params, momentum, EMA and BN statistics per leaf
within 1e-4 of the leaf's largest magnitude, floored at 1e-2 of the
tree's (the rule of tests/test_torch_train_step.py; measured 9.4e-6).

The Trainer and the train and eval CLIs on a config with build_type
'office' (office N's model section, configs/maf_yolo_n.py's solver and
augmentation): an epoch at 64 px, its checkpoint's meta.graph the JAX
package's office graph, resumed bit for bit, and the eval CLI of each
package on it."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.core.flatten import make_flatteners
from mafyolo_tpu.core.train_state import make_train_step as jax_make_train_step
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models import office as JO
from mafyolo_tpu_torch.core.engine import Trainer
from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models import office as O
from mafyolo_tpu_torch.tools import eval as eval_cli
from mafyolo_tpu_torch.tools import train as train_cli
from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from mafyolo_tpu_torch.utils.config import Config
from mafyolo_tpu_torch.utils.events import load_yaml
from tests.helpers import make_synth_dataset
from torch_common import prior_head_weights, to_jax, tree_leaves

NC = 7
ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", tuple(O.OFFICE_CONFIGS))
def test_train_forward_and_bn_stats_match_jax(name):
    graph = O.office_config_graph(name)
    model = build_model(graph, nc=NC)
    variables = random_train_variables(model.specs, seed=4)
    model.load_state_dict(train_variables_to_state_dict(variables))
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3))
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, mut = jax.tree.map(np.asarray, jax.jit(lambda v, a: jax_build_model(
            graph, nc=NC, dtype=jnp.float64).apply(v, a, train=True, mutable=["batch_stats"]))(
                f64, jnp.asarray(x, jnp.float64)))
    got = model.double().train()(torch.from_numpy(x))
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


def _assert_tree_close(got, want, what, share=1e-4):
    """Each leaf within `share` of its largest magnitude, floored at 1e-2 of
    the tree's."""
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys(), what
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-2 * top)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=share * scale, err_msg=f"{what}: {k}")


def test_office_n_train_steps_match_jax():
    """An apply step with TAL, then one with ATSS, in f64."""
    graph, img, wd = O.office_config_graph("yolov6n-office"), 128, 5e-4
    variables = prior_head_weights(graph, NC, seed=12)
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (2, img, img, 3), dtype=np.uint8)
    targets = np.zeros((2, 6, 5), np.float32)
    targets[..., 0] = -1
    targets[0, :3] = [[1, .3, .3, .3, .35], [3, .6, .55, .5, .4], [0, .8, .2, .2, .25]]
    targets[1, :2] = [[2, .5, .5, .8, .7], [6, .3, .7, .25, .2]]
    lrs = (0.01, 0.009, 0.08, 0.85)
    plan = (False, True)        # use_atss: TAL, then ATSS

    with jax.enable_x64(True):
        jmodel = jax_build_model(graph, nc=NC, dtype=jnp.float64)
        pf, sf, _ = make_flatteners(jmodel, img)
        flat = pf.flatten(to_jax(variables["params"]))
        stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["batch_stats"])
        jstate = {"params": flat, "batch_stats": stats,
                  "ema": {"params": flat, "batch_stats": sf.flatten(stats)},
                  "mom": jnp.zeros_like(flat), "grad_acc": jnp.zeros_like(flat),
                  "updates": jnp.zeros((), jnp.int32), "rng_step": jnp.zeros((), jnp.int32),
                  "wiou_mean": jnp.ones((), jnp.float32)}
        jstep = jax_make_train_step(jmodel, num_classes=NC, img_size=img, weight_decay=wd)
        want = []
        for use_atss in plan:
            jstate, jmet = jstep(jstate, jnp.asarray(imgs), jnp.asarray(targets),
                                 *map(jnp.float32, lrs), jnp.bool_(True), use_atss)
            want.append(jax.tree.map(np.asarray, {
                "metrics": {k: float(v) for k, v in jmet.items()},
                "updates": int(jstate["updates"]),
                "params": pf.unflatten(jstate["params"]), "stats": jstate["batch_stats"],
                "ema_params": pf.unflatten(jstate["ema"]["params"]),
                "ema_stats": sf.unflatten(jstate["ema"]["batch_stats"]),
                "mom": pf.unflatten(jstate["mom"])}))

    model = build_model(graph, nc=NC)
    model.load_state_dict(train_variables_to_state_dict(variables))
    model.double()
    state = init_train_state(model, weight_decay=wd)
    step = make_train_step(num_classes=NC, img_size=img)
    names = {id(p): n for n, p in model.named_parameters()}
    for use_atss, w in zip(plan, want):
        met = step(state, torch.from_numpy(imgs), torch.from_numpy(targets), *lrs, True,
                   use_atss)
        for k in ("loss", "iou", "dfl", "cls"):
            np.testing.assert_allclose(float(met[k]), w["metrics"][k], rtol=1e-4)
        assert state.updates == w["updates"]
        ours = state_dict_to_train_variables(model.state_dict())
        ema = state_dict_to_train_variables(state.ema.state_dict())
        for got, key in ((ours["params"], "params"), (ours["batch_stats"], "stats"),
                         (ema["params"], "ema_params"), (ema["batch_stats"], "ema_stats")):
            _assert_tree_close(got, w[key], key)
        mom = {names[id(p)]: st["momentum_buffer"] for p, st in state.optimizer.state.items()}
        assert len(mom) == len(names)
        _assert_tree_close(state_dict_to_train_variables(mom)["params"], w["mom"], "momentum")
    assert state.updates == 2
    moved = dict(tree_leaves(state_dict_to_train_variables(model.state_dict())["params"]))
    for k, v in tree_leaves(variables["params"]):
        if k.endswith("kernel"):
            assert not np.array_equal(moved[k], v), k


def _office_config(path: Path) -> Path:
    """configs/maf_yolo_n.py with office N's model section."""
    text = (ROOT / "configs" / "maf_yolo_n.py").read_text()
    head, rest = text.split("model = dict(", 1)
    rest = rest[rest.index("\nsolver = dict("):]
    model_cfg, mode = O.OFFICE_CONFIGS["yolov6n-office"]
    model_cfg = dict(model_cfg, head=dict(model_cfg["head"], iou_type="giou",
                                          atss_warmup_epoch=3))
    path.write_text(f"{head}model = {model_cfg!r}\ntraining_mode = {mode!r}{rest}")
    return path


def test_office_trainer_and_clis(tmp_path, monkeypatch):
    """The train CLI trains office N for an epoch (two steps, an eval on the
    EMA, the stripped checkpoints); a Trainer resumes its last checkpoint
    bit for bit; both eval CLIs read it (meta.graph, the office dict) and
    give the same metrics within 1e-6."""
    import tools.eval as jax_eval_cli
    monkeypatch.chdir(tmp_path)
    data = make_synth_dataset(tmp_path / "ds", n_images=8, img_size=96, nc=3, seed=6)
    cfg_path = _office_config(tmp_path / "office_n.py")
    cfg = Config.fromfile(str(cfg_path))
    assert cfg.model.build_type == "office"
    out = tmp_path / "runs"
    argv = ["--conf", str(cfg_path), "--data", data, "--img-size", "64", "--batch-size", "4",
            "--epochs", "2", "--workers", "1", "--output-dir", str(out),
            "--stop-aug-last-n-epoch", "0", "--eval-interval", "1", "--device", "cpu"]
    seen = {}
    real = Trainer.eval_and_save

    def spy(self, epoch):
        seen["graph"], seen["epoch"] = self.graph, epoch
        if epoch == 0:
            seen["ckpt0"] = self.checkpoint(epoch)
        return real(self, epoch)
    monkeypatch.setattr(Trainer, "eval_and_save", spy)
    train_cli.main(train_cli.get_args_parser().parse_args(argv))
    run = out / "exp"
    graph = JO.office_graph(*O.OFFICE_CONFIGS["yolov6n-office"])
    assert seen["graph"] == graph and seen["epoch"] == 1
    ckpt = load_checkpoint(str(run / "last_ckpt.npck"))
    assert ckpt["meta"]["graph"] == graph and ckpt["epoch"] == 1 and ckpt["ema"] is None

    # a Trainer resumes epoch 0's state bit for bit
    path = save_checkpoint(seen["ckpt0"], False, str(tmp_path / "c0"))
    args = train_cli.get_args_parser().parse_args(argv + ["--resume", path])
    args.save_dir = str(tmp_path / "resumed")
    tr = Trainer(args, cfg, load_yaml(data), device="cpu")
    assert tr.start_epoch == 1 and tr.graph == graph
    got = tr.checkpoint(0)
    for key in ("model", "ema", "opt"):
        g, w = dict(tree_leaves(got[key])), dict(tree_leaves(seen["ckpt0"][key]))
        assert g.keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_array_equal(g[k], v, err_msg=f"{key}: {k}")

    eval_argv = ["--weights", str(run / "last_ckpt.npck"), "--data", data, "--img-size", "64",
                 "--batch-size", "4", "--half", "0", "--workers", "1", "--conf-thres",
                 "0.001", "--do_pr_metric"]
    got = eval_cli.run(eval_cli.get_args_parser().parse_args(eval_argv + ["--device", "cpu"]))
    want = jax_eval_cli.run(jax_eval_cli.get_args_parser().parse_args(eval_argv))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
