"""The port's train CLI (python -m mafyolo_tpu_torch.tools.train --device
cpu) against the JAX CLI (tools/train.py), f32 on the CPU, and the JAX
Trainer resuming the port's checkpoint.

The run: the port's Trainer trains epoch 0 of 2 on `make_synth_dataset`
(8 images, 3 classes) at 128 px, bs 4, one loader worker, TINY_GRAPH from
torch_common.prior_head_weights, and saves last_ckpt.npck. Both CLIs then
`--resume` that checkpoint and run epoch 1, which is the stop-aug tail
(--stop-aug-last-n-epoch 1: the loader rebuilt without mosaic) and the last
epoch (eval, then strip). The JAX CLI is the second and last JAX Trainer
built by these tests (tests/test_torch_trainer.py builds the first).

Gates: the JAX Trainer's state at the start of train() equals the port's
checkpoint bit for bit (params, BN stats, EMA, momentum, updates, start
epoch); both CLIs write the same files; their stripped last_ckpt.npck
(the EMA in fp16) agree leaf by leaf within 5e-3 x the leaf's largest
magnitude (floored at 1e-2 of the tree's), the momentum tolerance of
tests/test_torch_trainer.py: after four warm-up steps at bias lr 0.1 the
last steps' gradients decide the BN biases of layers 0-1, whose gradients
nearly cancel (measured 2.3e-3 of such a leaf at worst, 4 fp16 steps)."""
import importlib
import os
from pathlib import Path

import numpy as np
import pytest

from helpers import TINY_GRAPH
from mafyolo_tpu.core.engine import Trainer as JaxTrainer
from mafyolo_tpu_torch.core.engine import Trainer
from mafyolo_tpu_torch.tools import train as port_cli
from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
from mafyolo_tpu_torch.utils.config import Config
from mafyolo_tpu_torch.utils.events import load_yaml
from tests.helpers import make_synth_dataset
from torch_common import prior_head_weights, tree_leaves

NC, IMG = 3, 128
ROOT = Path(__file__).resolve().parent.parent


def _argv(cfg, data, out, resume):
    return ["--conf", cfg, "--data", data, "--img-size", str(IMG), "--batch-size", "4",
            "--epochs", "2", "--workers", "1", "--output-dir", out, "--resume", resume,
            "--stop-aug-last-n-epoch", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import pickle
    root = tmp_path_factory.mktemp("train_cli")
    data_yaml = make_synth_dataset(root / "ds", n_images=8, img_size=96, nc=NC, seed=6)
    cfg_path = root / "tiny.py"
    cfg_path.write_text((ROOT / "configs" / "maf_yolo_n.py").read_text().replace(
        'graph="maf-yolo-n",', f"graph={TINY_GRAPH!r},"))
    pre = root / "pre.npck"
    pre.write_bytes(pickle.dumps({"model": prior_head_weights(TINY_GRAPH, NC)}))

    class Args:
        img_size, batch_size, epochs, workers, seed = IMG, 4, 2, 1, 0
        save_dir, pretrained, tensorboard = str(root / "port0"), str(pre), False
        stop_aug_last_n_epoch = 1
    tr = Trainer(Args(), Config.fromfile(str(cfg_path)), load_yaml(data_yaml), device="cpu")
    tr.train_one_epoch(0)
    tr.eval_and_save(0)
    ckpt0 = str(root / "port0" / "last_ckpt.npck")

    jax_cli = importlib.import_module("tools.train")
    seen = {}
    train = JaxTrainer.train

    def spy(self):
        seen.update(
            start_epoch=self.start_epoch, updates=int(self.state["updates"]),
            model={"params": self._pf.unflatten(self.state["params"]),
                   "batch_stats": self.state["batch_stats"]},
            ema={"params": self._pf.unflatten(self.state["ema"]["params"]),
                 "batch_stats": self._sf.unflatten(self.state["ema"]["batch_stats"])},
            opt=self._pf.unflatten(self.state["mom"]))
        return train(self)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTrainer, "train", spy)
        jax_cli.main(jax_cli.get_args_parser().parse_args(
            _argv(str(cfg_path), data_yaml, str(root / "jax"), ckpt0) + ["--device-count", "1"]))
    port_cli.main(port_cli.get_args_parser().parse_args(
        _argv(str(cfg_path), data_yaml, str(root / "port"), ckpt0) + ["--device", "cpu"]))
    return dict(root=root, ckpt0=ckpt0, seen=seen)


def test_jax_trainer_resumes_the_port_checkpoint(runs):
    want, seen = load_checkpoint(runs["ckpt0"]), runs["seen"]
    assert want["epoch"] == 0 and seen["start_epoch"] == 1
    assert seen["updates"] == want["updates"] == 2
    for key in ("model", "ema", "opt"):
        got, exp = dict(tree_leaves(seen[key])), dict(tree_leaves(want[key]))
        assert got.keys() == exp.keys(), key
        for k, v in exp.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{key}: {k}")


def test_train_cli_matches_jax_cli(runs):
    jdir, pdir = runs["root"] / "jax" / "exp", runs["root"] / "port" / "exp"

    def files(d):
        return sorted("events" if f.startswith("events.out.tfevents") else f
                      for f in os.listdir(d))
    assert files(pdir) == files(jdir)
    assert {"args.yaml", "last_ckpt.npck"} <= set(files(pdir))
    pargs, jargs = load_yaml(pdir / "args.yaml"), load_yaml(jdir / "args.yaml")
    assert set(pargs) - set(jargs) == {"device"} and pargs["device"] == "cpu"
    mine, theirs = load_checkpoint(str(pdir / "last_ckpt.npck")), \
        load_checkpoint(str(jdir / "last_ckpt.npck"))
    assert mine.keys() == theirs.keys() and mine["ema"] is theirs["ema"] is None
    assert mine["epoch"] == theirs["epoch"] == 1 and "opt" not in mine
    got, want = dict(tree_leaves(mine["model"])), dict(tree_leaves(theirs["model"]))
    assert got.keys() == want.keys()
    top = max(np.abs(w.astype(np.float32)).max() for w in want.values())
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float16, k
        w = w.astype(np.float32)
        scale = max(np.abs(w).max(), 1e-2 * top)
        np.testing.assert_allclose(got[k].astype(np.float32), w, rtol=0, atol=5e-3 * scale,
                                   err_msg=k)
