"""Data parallel (mafyolo_tpu_torch/parallel/ddp.py) on the CPU: two gloo
ranks (init_method file:// under tmp_path) run MAF-YOLO-N's train step at
64 px on the two halves of a global batch of 8, against one process of the
port on the whole batch and JAX's 1-device make_train_step (the sharded
step's reference, tests/test_multidev_equivalence.py), with device
augmentation off and on.

Rank r holds rows r::2 of the global batch (the loader's stride). Each case
is a step plan: without device augmentation an apply step, an
accumulate-only step and an apply step (the two steps' grads summed across
the ranks at the apply), with ATSS; with device augmentation one apply step
with TAL each, without the mosaic (each rank augments its rows with their
draws) and with the mosaic and mixup (each rank gathers the global batch
and warps its rows and their mixup partners). The augmentation's draws are
JAX's own for its step's key (torch_common.jax_aug_params), handed to the
port in place of its generator's, so all three augment alike. The hyps take
JAX's gather warps (degrees and shear nonzero) with HSV off: JAX's
separable forms and its fused HSV differ from the port's by up to 2e-2 and
on 0.1% of pixels (tests/test_torch_device_aug.py).

Both packages compute in f64 (the port's model in double, JAX's flax model
with dtype float64 under jax.enable_x64; JAX keeps its flat params,
momentum and EMA in f32, and both losses are f32): at 64 px the deepest
BNs normalize 32 values a channel (2 x 2 px x 8 images), and in f32 the
rounding of the train-mode backward alone puts the one-process port and
JAX 9.1e-4 of a momentum leaf's scale apart, past the multidev test's
tolerances. In f64 every leaf is held at them, elementwise: loss
components, params, EMA and BN running statistics (model and EMA) rtol
1e-5 / atol 1e-6, momentum (the raw gradient) rtol 1e-4 / atol 2e-5. The
two ranks' states are equal bit for bit: each computes the same update from
the same all-reduced sums. The weights are JAX's init (zero preds), as
tests/test_multidev_equivalence.py starts."""
import concurrent.futures
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mafyolo_tpu.core.flatten import make_flatteners
from mafyolo_tpu.core.train_state import make_train_step as jax_make_train_step
from mafyolo_tpu.data import device_aug as J
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
from mafyolo_tpu_torch.data import device_aug as DA
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.parallel import ddp
from mafyolo_tpu_torch.utils.bridge import (state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from torch_common import jax_aug_params, tree_leaves

NC, IMG, BATCH, WORLD, WD, LR, MOM, SEED = 5, 64, 8, 2, 5e-4, 0.01, 0.9, 0
AUG = dict(degrees=5.0, translate=0.1, scale=0.5, shear=3.0, hsv_h=0.0, hsv_s=0.0,
           hsv_v=0.0, fliplr=0.5, flipud=0.5, mosaic=0.0, mixup=0.0, dy_label=5,
           dy_mixup=0.0)
# name -> (device_aug hyps, [(do_apply, use_atss)])
CASES = {
    "plain": (None, [(True, True), (False, True), (True, True)]),
    "aug_rows": (AUG, [(True, False)]),
    "aug_mosaic": (dict(AUG, mosaic=0.8, mixup=0.5, dy_mixup=1.0, dy_label=2),
                   [(True, False)]),
}
AUG_CASES = [name for name, (aug, _) in CASES.items() if aug]


def _batch():
    """The JAX multidev test's batch: uint8 images, two boxes an image."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 255, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    targets = np.full((BATCH, 8, 5), -1, np.float32)
    for i in range(BATCH):
        targets[i, 0] = [rng.integers(NC), 0.5, 0.5, 0.4, 0.4]
        targets[i, 1] = [rng.integers(NC), 0.25, 0.25, 0.2, 0.3]
    return imgs, targets


def _jax_state(model, variables):
    """JAX's train state holding `variables` (init_train_state's layout),
    the BN statistics in f64 as the f64 model writes them."""
    pf, sf, _ = make_flatteners(model, IMG)
    flat = pf.flatten(variables["params"])
    stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["batch_stats"])
    return {"params": flat, "batch_stats": stats,
            "ema": {"params": flat, "batch_stats": sf.flatten(stats)},
            "mom": jnp.zeros_like(flat), "grad_acc": jnp.zeros_like(flat),
            "updates": jnp.zeros((), jnp.int32), "rng_step": jnp.zeros((), jnp.int32),
            "wiou_mean": jnp.ones((), jnp.float32)}, pf, sf


def _jax_key(x64: bool = True):
    """The key JAX's step folds its first step count into (make_train_step)."""
    with jax.enable_x64(x64):
        return jax.random.fold_in(jax.random.PRNGKey(SEED ^ 0x5DEECE66D),
                                  jnp.zeros((), jnp.int32))


def _jax_draws(aug):
    """JAX's augmentation draws for its first f64 step, in the port's layout
    and dtypes (f32), or None."""
    if not aug:
        return None
    with jax.enable_x64(True):
        p = jax_aug_params(_jax_key(), BATCH, IMG, IMG, **aug)
    return {k: v.float() if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in p.items()}


def _run_jax(variables, imgs, targets, aug, plan):
    """JAX's f64 steps of `plan` on the whole batch -> state and metrics,
    numpy."""
    with jax.enable_x64(True):
        model = jax_build_model("maf-yolo-n", nc=NC, dtype=jnp.float64)
        state, pf, sf = _jax_state(model, variables)
        step = jax_make_train_step(model, num_classes=NC, img_size=IMG, weight_decay=WD,
                                   device_aug=aug, seed=SEED)
        lr, metrics = jnp.float32(LR), []
        for do_apply, use_atss in plan:
            state, m = step(state, jnp.asarray(imgs), jnp.asarray(targets), lr, lr, lr,
                            jnp.float32(MOM), jnp.bool_(do_apply), use_atss)
            metrics.append({k: float(v) for k, v in m.items()})
        out = {"metrics": metrics, "updates": int(state["updates"]),
               "model": {"params": pf.unflatten(state["params"]),
                         "batch_stats": state["batch_stats"]},
               "ema": {"params": pf.unflatten(state["ema"]["params"]),
                       "batch_stats": sf.unflatten(state["ema"]["batch_stats"])},
               "mom": pf.unflatten(state["mom"])}
        return jax.tree.map(np.asarray, out)


def _run(variables, imgs, targets, aug, plan, draws):
    """The port's f64 steps of `plan` (draws: the device augmentation's
    parameters, in place of its generator's) -> the state and each step's
    metrics, numpy."""
    model = build_model("maf-yolo-n", nc=NC)
    model.load_state_dict(train_variables_to_state_dict(variables))
    model.double()
    state = init_train_state(model, weight_decay=WD)
    step = make_train_step(num_classes=NC, img_size=IMG, device_aug=aug, seed=SEED)
    draw = DA.draw
    DA.draw = lambda b, *args, **kw: draws
    try:
        metrics = [{k: float(v) for k, v in step(
            state, torch.from_numpy(imgs), torch.from_numpy(targets), LR, LR, LR, MOM,
            do_apply, use_atss).items()} for do_apply, use_atss in plan]
    finally:
        DA.draw = draw
    names = {id(p): n for n, p in model.named_parameters()}
    mom = {names[id(p)]: st["momentum_buffer"] for p, st in state.optimizer.state.items()}
    return {"metrics": metrics, "model": state_dict_to_train_variables(model.state_dict()),
            "ema": state_dict_to_train_variables(state.ema.state_dict()),
            "mom": state_dict_to_train_variables(mom)["params"], "updates": state.updates}


def _rank(rank, init_method, out_dir, variables, imgs, targets, draws):
    torch.set_num_threads(1)
    ddp.init_distributed("cpu", init_method=init_method, rank=rank, world=WORLD)
    try:
        assert ddp.world_size() == WORLD and ddp.is_main_process() == (rank == 0)
        out = {name: _run(variables, imgs[rank::WORLD], targets[rank::WORLD], aug, plan,
                          draws[name])
               for name, (aug, plan) in CASES.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks run (spawned) while JAX compiles and runs its three
    cases, one thread each; then the port's one process."""
    tmp = tmp_path_factory.mktemp("ddp")
    jmodel = jax_build_model("maf-yolo-n", nc=NC)
    variables = jax.tree.map(np.asarray, jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, IMG, IMG, 3)), train=False))(jax.random.PRNGKey(0)))
    imgs, targets = _batch()
    draws = {name: _jax_draws(aug) for name, (aug, _) in CASES.items()}
    ctx = torch.multiprocessing.spawn(
        _rank, args=(f"file://{tmp}/rendezvous", str(tmp), variables, imgs, targets, draws),
        nprocs=WORLD, join=False)
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        futures = {name: pool.submit(_run_jax, variables, imgs, targets, aug, plan)
                   for name, (aug, plan) in CASES.items()}
        jax_out = {name: f.result() for name, f in futures.items()}
    one = {name: _run(variables, imgs, targets, aug, plan, draws[name])
           for name, (aug, plan) in CASES.items()}
    while not ctx.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, one, jax_out, draws


def _assert_state_close(got, want, what, stats_rtol=1e-5):
    for k in ("loss", "iou", "dfl", "cls"):
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")
    assert got["updates"] == want["updates"]
    for tree in ("model", "ema", "mom"):
        g, w = dict(tree_leaves(got[tree])), dict(tree_leaves(want[tree]))
        assert g.keys() == w.keys() and len(w) > 100, f"{what} {tree}"
        for k in w:
            rtol, atol = (1e-4, 2e-5) if tree == "mom" else (
                stats_rtol if k.startswith("batch_stats") else 1e-5, 1e-6)
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{what} {tree}: {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_process(runs, name):
    ranks, one, _, _ = runs
    a, b = ranks[0][name], ranks[1][name]
    assert a["metrics"] == b["metrics"]
    for tree in ("model", "ema", "mom"):
        for (k, x), (_, y) in zip(tree_leaves(a[tree]), tree_leaves(b[tree])):
            assert np.array_equal(x, y), f"rank states differ: {tree} {k}"
    _assert_state_close(a, one[name], f"2 ranks vs 1 process, {name}")
    assert a["updates"] == sum(d for d, _ in CASES[name][1])


def test_two_ranks_match_jax_one_device(runs):
    ranks, _, jax_out, _ = runs
    _assert_state_close(ranks[0]["plain"], jax_out["plain"], "2 ranks vs JAX 1 device")


@pytest.mark.parametrize("name", AUG_CASES)
def test_two_ranks_with_device_aug_match_jax(runs, name):
    """The augmented steps against JAX's own, whose draws moved the images
    (flips both ways, and mosaics with mixup where the case has them). The
    port inverts the affine and sums the source coordinates in JAX's order
    (data/device_aug.py:inv3, _source_coords), so a pixel sits at most
    1.9e-7 from JAX's (measured here on the CPU; 1.4e-5 while the port
    inverted by torch.linalg.inv) and the BN statistics within rtol 6.3e-7.
    The images are held at atol 1e-6 and the statistics at rtol 1e-5, as
    everything else at the multidev tolerances."""
    ranks, _, jax_out, draws = runs
    p = draws[name]
    assert p["do_lr"].any() and p["do_ud"].any() and "m" in p
    if "donors" in p:
        assert p["do_mo"].any() and (p["do_mo"] & (p["u_mix"] | p["u_dy"])).any()
    with jax.enable_x64(True):
        want_img, _ = J.device_augment(jnp.asarray(_batch()[0]), jnp.asarray(_batch()[1]),
                                       _jax_key(), **CASES[name][0])
    got_img, _ = DA.apply(*(torch.from_numpy(a) for a in _batch()), p)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-6)
    _assert_state_close(ranks[0][name], jax_out[name], f"2 ranks vs JAX 1 device, {name}",
                        stats_rtol=1e-5)


@pytest.mark.parametrize("cfg", [dict(AUG, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4),
                                 dict(CASES["aug_mosaic"][0], mosaic=0.6, mixup=1.0)])
def test_a_share_of_the_batch_augments_as_the_whole(cfg):
    """device_aug.apply's `rows` (a rank's share, which warps only its rows
    and their mixup partners) gives the whole batch's rows bit for bit."""
    imgs, targets = (torch.from_numpy(a) for a in _batch())
    p = DA.draw(BATCH, IMG, IMG, torch.Generator().manual_seed(3), **cfg)
    want_img, want_lbl = DA.apply(imgs, targets, p)
    for world in (2, 4):
        for r in range(world):
            rows = torch.arange(r, BATCH, world)
            got_img, got_lbl = DA.apply(imgs, targets, p, rows)
            assert torch.equal(got_img, want_img[rows]) and torch.equal(got_lbl, want_lbl[rows])


def test_one_rank_without_a_group_and_device_checks():
    """Without a process group there is one rank, the main one, owning every
    row; more CUDA devices than the host has raise; NCCL is the card's
    backend, gloo the CPU's."""
    assert not ddp.active() and ddp.world_size() == 1 and ddp.is_main_process()
    assert torch.equal(ddp.own_rows(3, "cpu"), torch.arange(3))
    assert ddp.check_devices(2, "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="CUDA device"):
        ddp.check_devices(torch.cuda.device_count() + 1, "cuda")
    assert ddp.default_backend("cuda:0") == "nccl" and ddp.default_backend("cpu") == "gloo"


def test_launch_from_standard_input_raises():
    """A program read from standard input cannot spawn ranks (each re-runs
    the main module's file): launch raises at once instead of waiting."""
    import subprocess
    import sys
    script = ("from mafyolo_tpu_torch.parallel import ddp\n"
              "ddp.launch(print, 2, device='cpu')\n")
    res = subprocess.run([sys.executable, "-"], input=script, capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert res.returncode != 0 and "python -m" in res.stderr, res.stderr


def test_train_cli_device_count_two_ranks(tmp_path):
    """tools/train.py --device-count 2 --device cpu: two spawned gloo ranks
    train an epoch of TINY_GRAPH on a synth set; rank 0 alone names the run
    directory, evaluates and writes (and strips) its checkpoints."""
    from helpers import TINY_GRAPH
    from mafyolo_tpu_torch.tools import train as train_cli
    from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
    from tests.helpers import make_synth_dataset
    data = make_synth_dataset(tmp_path / "ds", n_images=8, img_size=64, nc=3, seed=3)
    cfg = tmp_path / "tiny.py"
    cfg.write_text(open("configs/maf_yolo_n.py").read().replace(
        'graph="maf-yolo-n",', f"graph={TINY_GRAPH!r},"))
    out = tmp_path / "runs"
    train_cli.main(train_cli.get_args_parser().parse_args(
        ["--conf", str(cfg), "--data", str(data), "--img-size", "64", "--batch-size", "4",
         "--epochs", "1", "--workers", "1", "--output-dir", str(out), "--device", "cpu",
         "--device-count", "2", "--stop-aug-last-n-epoch", "0"]))
    assert sorted(p.name for p in out.iterdir()) == ["exp"]
    ckpt = load_checkpoint(str(out / "exp" / "last_ckpt.npck"))
    assert ckpt["ema"] is None and ckpt["epoch"] == 0 and (out / "exp" / "args.yaml").exists()
    assert all(np.isfinite(v).all() for _, v in tree_leaves(ckpt["model"]))
