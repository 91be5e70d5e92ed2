"""Per-block rematerialization (models/graph.py:GraphNet remat, policies
"full" and "convs") on the CPU, f32 unless stated.

TINY_GRAPH (a RepHDW row: the DW conv's hand-written backward and dw_grad's
plain version are on the backward) at 128 px, three steps (accumulate-only
with ATSS, apply with ATSS, apply with TAL):
  - the port with remat, under each policy, against JAX's make_train_step
    of build_model(remat=True), its ATSS steps under remat_policy "full" and
    its TAL step under "convs", at test_three_train_steps_match_jax's
    tolerance;
  - the port with remat against the port without, bit for bit (params, BN
    statistics, EMA, momentum, Wise-IoU's running mean), each BN's running
    statistics written once a step;
  - the recompute is real: under either policy each wrapped block's forward
    runs twice a step, under "full" the backward runs convolutions again
    and under "convs" none;
and MAF-YOLO-N's repopt plain graph and office N's rows under remat equal
to without, two gloo ranks under remat against one process (f64, the
tolerances of tests/test_torch_ddp.py), the rows wrapped, the policies'
names, and the blocks run plainly where no gradient is taken."""
import inspect
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from helpers import TINY_GRAPH
from mafyolo_tpu.core.flatten import make_flatteners
from mafyolo_tpu.core.train_state import make_train_step as jax_make_train_step
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.solver.build import build_lr_fn as jax_build_lr_fn
from mafyolo_tpu.solver.build import warmup_schedule as jax_warmup_schedule
from mafyolo_tpu_torch.models import blocks as B
from mafyolo_tpu_torch.models import graph as G
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.office import office_config_graph
from mafyolo_tpu_torch.solver import repopt as R
from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from test_torch_train_step import _assert_tree_close, _batch
from torch_common import remat_rank, to_jax, train_steps

NC, IMG, WD = 4, 128, 5e-4
POLICIES = ("full", "convs")


def _lrs(curr_step):
    s = jax_warmup_schedule(curr_step, 1000, 0, jax_build_lr_fn("linear", 0.01, 300), 0.01, 2,
                            0.1, 0.8, 0.937)
    return s["lr_bnw"], s["lr_weight"], s["lr_bias"], s["momentum"]


# (lrs, do_apply, use_atss): test_three_train_steps_match_jax's plan
PLAN = tuple((_lrs(c), a, u) for c, a, u in ((1400, False, True), (1401, True, True),
                                             (1402, True, False)))
# the JAX remat policy of the ATSS steps and of the TAL step
JAX_POLICY = {True: "full", False: "convs"}


def _jax_args(entry, imgs, targets):
    lrs, do_apply, _ = entry
    return (jnp.asarray(imgs), jnp.asarray(targets), *map(jnp.float32, lrs),
            jnp.bool_(do_apply))


# two gloo ranks under remat against one process, f64
DDP_IMG, DDP_BATCH, WORLD = 64, 4, 2
DDP_PLAN = (PLAN[1], PLAN[0], PLAN[2])     # apply, accumulate-only, apply


def _ddp_batch():
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 255, (DDP_BATCH, DDP_IMG, DDP_IMG, 3), dtype=np.uint8)
    targets = np.full((DDP_BATCH, 4, 5), -1, np.float32)
    for i in range(DDP_BATCH):
        targets[i, 0] = [rng.integers(NC), 0.5, 0.5, 0.4, 0.4]
        targets[i, 1] = [rng.integers(NC), 0.25, 0.25, 0.2, 0.3]
    return imgs, targets


@pytest.fixture(scope="module")
def spawned_ranks(tmp_path_factory):
    """The two gloo ranks of test_two_ranks_under_remat_match_one_process,
    spawned (tests/torch_common.py:remat_rank, without remat and under each
    policy) before JAX compiles, so the two overlap, and joined at the end.
    -> (the spawn context, the ranks' directory, the weights)."""
    tmp = tmp_path_factory.mktemp("remat_ranks")
    variables = random_train_variables(build_model(TINY_GRAPH, nc=NC).specs, seed=16)
    ctx = torch.multiprocessing.spawn(
        remat_rank, args=(WORLD, f"file://{tmp}/rendezvous", str(tmp / "rank%d.pkl"),
                          TINY_GRAPH, variables, *_ddp_batch(), DDP_PLAN, NC,
                          (None, *POLICIES)), nprocs=WORLD, join=False)
    yield ctx, tmp, variables
    while not ctx.join():
        pass


@pytest.fixture(scope="module")
def jax_runs(spawned_ranks):
    """TINY_GRAPH's random weights and JAX's three steps under remat, from
    init_train_state's layout holding them: the ATSS steps by
    build_model(remat=True, remat_policy="full"), the TAL step by
    remat_policy="convs" (each JAX executable takes 15-20 s to lower and
    compile here, so each policy compiles one of the step's two forms). ->
    (variables, after each step: the metrics, updates, and the params, BN
    statistics, EMA and momentum trees, numpy)."""
    variables = random_train_variables(build_model(TINY_GRAPH, nc=NC).specs, seed=12)
    imgs, targets = _batch()
    pf, sf, _ = make_flatteners(jax_build_model(TINY_GRAPH, nc=NC), IMG)
    jv = to_jax(variables)
    flat = pf.flatten(jv["params"])
    state = {"params": flat, "batch_stats": jv["batch_stats"],
             "ema": {"params": flat, "batch_stats": sf.flatten(jv["batch_stats"])},
             "mom": jnp.zeros_like(flat), "grad_acc": jnp.zeros_like(flat),
             "updates": jnp.zeros((), jnp.int32), "rng_step": jnp.zeros((), jnp.int32),
             "wiou_mean": jnp.ones((), jnp.float32)}
    steps = {use_atss: jax_make_train_step(
        jax_build_model(TINY_GRAPH, nc=NC, remat=True, remat_policy=policy),
        num_classes=NC, img_size=IMG, weight_decay=WD) for use_atss, policy in JAX_POLICY.items()}
    out = []
    for entry in PLAN:
        state, met = steps[entry[2]](state, *_jax_args(entry, imgs, targets),
                                     use_atss=entry[2])
        out.append(jax.tree.map(np.asarray, {
            "metrics": met, "updates": state["updates"],
            "params": pf.unflatten(state["params"]), "batch_stats": state["batch_stats"],
            "ema_params": pf.unflatten(state["ema"]["params"]),
            "ema_stats": sf.unflatten(state["ema"]["batch_stats"]),
            "mom": pf.unflatten(state["mom"])}))
    return variables, out


def _port_steps(graph, variables, imgs, targets, plan=None, **kw):
    return train_steps(graph, variables, imgs, targets, plan or PLAN, nc=NC, **kw)


def _assert_runs_equal(got, want, what):
    for i, ((s, met, ver), (s0, met0, ver0)) in enumerate(zip(got, want)):
        assert met == met0 and ver == ver0, f"{what} step {i}"
        assert s["updates"] == s0["updates"] and torch.equal(s["wiou_mean"], s0["wiou_mean"])
        for tree in ("model", "ema", "mom"):
            assert s[tree].keys() == s0[tree].keys(), f"{what} step {i} {tree}"
            for k, v in s0[tree].items():
                assert torch.equal(s[tree][k], v), f"{what} step {i} {tree}: {k}"


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_steps_match_jax_remat(jax_runs, policy):
    """Three steps of the port under remat with `policy` against JAX's
    make_train_step of build_model(remat=True) (JAX_POLICY), after each
    step, at test_three_train_steps_match_jax's tolerance (its docstring
    says why)."""
    variables, jax_out = jax_runs
    imgs, targets = _batch()
    ours = _port_steps(TINY_GRAPH, variables, imgs, targets, remat=policy)
    for (snap, met, _), want in zip(ours, jax_out):
        for k in ("loss", "iou", "dfl", "cls"):
            np.testing.assert_allclose(met[k], float(want["metrics"][k]), rtol=1e-4)
        assert snap["updates"] == int(want["updates"])
        tree = state_dict_to_train_variables(snap["model"])
        _assert_tree_close(tree["params"], want["params"], "params")
        _assert_tree_close(tree["batch_stats"], want["batch_stats"], "batch_stats")
        ema = state_dict_to_train_variables(snap["ema"])
        _assert_tree_close(ema["params"], want["ema_params"], "ema params")
        _assert_tree_close(ema["batch_stats"], want["ema_stats"], "ema stats")
        if snap["updates"]:
            _assert_tree_close(state_dict_to_train_variables(snap["mom"])["params"],
                               want["mom"], "momentum")
    assert ours[-1][0]["updates"] == 2


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_steps_equal_no_remat_bit_for_bit(policy):
    """The same three steps with Wise-IoU (its running mean moves on every
    step) with and without remat: every leaf and metric equal, and each BN's
    running mean and variance written once a step (two in-place ops, the
    buffers' version count), as without."""
    variables = random_train_variables(build_model(TINY_GRAPH, nc=NC).specs, seed=14)
    imgs, targets = _batch()
    off = _port_steps(TINY_GRAPH, variables, imgs, targets, iou_type="wiou")
    on = _port_steps(TINY_GRAPH, variables, imgs, targets, remat=policy, iou_type="wiou")
    _assert_runs_equal(on, off, f"remat {policy}")
    assert all(v == 2 for _, _, ver in on for v in ver.values()) and len(on[0][2]) > 20
    assert not torch.equal(off[-1][0]["wiou_mean"], torch.ones(()))


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that execute, by whether a rematerialized block's
    recompute runs them (an op that selective checkpointing serves from its
    cache does not reach a mode below it)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = (func, B.recomputing())
        self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _forward_counts(model):
    counts = {}
    for idx in model.net.remat_rows:
        getattr(model.net, f"layer{idx}").register_forward_pre_hook(
            lambda m, a, idx=idx: counts.__setitem__(idx, counts.get(idx, 0) + 1))
    return counts


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_recomputes_each_block(policy):
    """A forward and backward in train mode: every wrapped block's forward
    runs twice (the recompute), and the recompute runs aten.convolution again
    under "full" (up to one a conv of the graph: it stops once the backward's
    saved tensors are back) and never under "convs", which keeps the conv
    outputs and recomputes the rest."""
    torch.manual_seed(0)
    model = build_model(TINY_GRAPH, nc=NC, remat=True, remat_policy=policy).train()
    counts = _forward_counts(model)
    x = torch.rand(2, 64, 64, 3)
    with _CountOps() as fwd:
        outs = model(x)
    loss = sum(t.float().square().mean() for level in outs for t in level)
    with _CountOps() as bwd:
        loss.backward()
    assert counts == dict.fromkeys(model.net.remat_rows, 2)
    convs = torch.ops.aten.convolution.default
    n_convs = sum(isinstance(m, (torch.nn.Conv2d, B.DWConv)) for m in model.modules())
    assert fwd.counts == {k: v for k, v in fwd.counts.items() if not k[1]}
    assert fwd.counts[convs, False] == n_convs
    recomputed = bwd.counts.get((convs, True), 0)
    assert (0 < recomputed <= n_convs) if policy == "full" else recomputed == 0
    assert sum(v for (_, rec), v in bwd.counts.items() if rec) > 0
    assert bwd.counts[torch.ops.aten.convolution_backward.default, False] > 0


def test_blocks_run_plainly_where_no_gradient_is_taken():
    """Eval mode, no_grad and the deploy form's calibration run each block
    once: the BN statistics of a train-mode no_grad forward move once, and a
    calibration histogram under remat with a gradient taken counts the batch
    once, equal to the one without remat."""
    torch.manual_seed(0)
    model = build_model(TINY_GRAPH, nc=NC, remat=True)
    counts = _forward_counts(model)
    x = torch.rand(2, 64, 64, 3)
    model.eval()(x)
    with torch.no_grad():
        model.train()(x)
    assert counts == dict.fromkeys(model.net.remat_rows, 2)
    assert all(b._version == 2 for n, b in model.named_buffers() if n.endswith("running_mean"))

    hists = []
    for remat in (False, True):
        torch.manual_seed(1)
        m = build_model(TINY_GRAPH, nc=NC, deploy=True, quant=True, calibrate=True,
                        remat=remat).train()
        B.set_quant_mode(m, "calib", hist_bins=64)
        loss = sum(t.float().sum() for level in m(x) for t in level)
        loss.backward()
        hists.append({k: v.clone() for k, v in m.state_dict().items()
                      if k.endswith(("act_hist", "act_amax"))})
    assert hists[0].keys() == hists[1].keys() and len(hists[0]) > 10
    for k, v in hists[0].items():
        assert torch.equal(hists[1][k], v), k
        if k.endswith("act_hist"):
            assert v.sum() > 0


@pytest.mark.parametrize("graph", ["repopt", "yolov6n-office"])
def test_repopt_and_office_rows_under_remat_bit_for_bit(graph):
    """MAF-YOLO-N's repopt plain graph (RealVGG rows, masked gradients) and
    office N (RepBlock, BepC3, SimSPPF, Transpose, Head_Effide rows) under
    each policy: two steps at 64 px (accumulate-only, apply), every leaf
    equal to the run without remat."""
    kw = {}
    if graph == "repopt":
        model = build_model("maf-yolo-n", nc=NC, plain_rep=True)
        masks = R.repopt_prepare(model, R.random_scales_like(model, np.random.default_rng(1)),
                                 np.random.default_rng(2))
        kw["grad_mask"] = masks
        g, variables = "maf-yolo-n", state_dict_to_train_variables(model.state_dict())
    else:
        g = office_config_graph(graph)
        variables = random_train_variables(build_model(g, nc=NC).specs, seed=5)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    targets = _batch()[1]
    plan = PLAN[:2]
    off = _port_steps(g, variables, imgs, targets, plan=plan, **kw)
    for policy in POLICIES:
        _assert_runs_equal(_port_steps(g, variables, imgs, targets, plan=plan, remat=policy,
                                       **kw), off, f"{graph} remat {policy}")
    assert off[-1][0]["updates"] == 1


def test_remat_rows_and_policies():
    """build_model takes JAX's remat arguments with JAX's defaults; remat
    wraps every block row, heads and office rows included, and no Upsample
    or Concat row; an unknown policy raises ValueError, and "convs" without
    torch's selective checkpointing raises naming it instead of running
    "full"."""
    ours = inspect.signature(build_model).parameters
    theirs = inspect.signature(jax_build_model).parameters
    for name in ("remat", "remat_policy"):
        assert ours[name].default == theirs[name].default
    for graph in ("maf-yolo-n", office_config_graph("yolov6l-office")):
        net = build_model(graph, nc=NC, remat=True).net
        kinds = {s.idx: s.kind for s in net.specs}
        assert net.remat_rows == {i for i, k in kinds.items() if k in G._BLOCK_CTORS}
        assert {kinds[i] for i in set(kinds) - net.remat_rows} <= {"Upsample", "Concat", "Out"}
        assert "Concat" in kinds.values()
        assert ("Upsample" if graph == "maf-yolo-n" else "Transpose") in kinds.values()
        assert not build_model(graph, nc=NC).net.remat_rows
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(TINY_GRAPH, nc=NC, remat=True, remat_policy="dots")
    saved = G.ckpt.create_selective_checkpoint_contexts
    del G.ckpt.create_selective_checkpoint_contexts
    try:
        with pytest.raises(RuntimeError, match="create_selective_checkpoint_contexts"):
            build_model(TINY_GRAPH, nc=NC, remat=True, remat_policy="convs")
    finally:
        G.ckpt.create_selective_checkpoint_contexts = saved


def test_two_ranks_under_remat_match_one_process(spawned_ranks):
    """Two gloo ranks, each half of a global batch of 4 at 64 px, TINY_GRAPH
    in f64, an apply, an accumulate-only and an apply step under each
    policy: bit-equal to the same ranks without remat, so the global BN
    statistics (their all-reduce issued again in the recompute) moved once
    a step, as the version counts show; and within tests/test_torch_ddp.py's
    tolerances of one process on the whole batch without remat."""
    ctx, tmp, variables = spawned_ranks
    one = _port_steps(TINY_GRAPH, variables, *_ddp_batch(), plan=DDP_PLAN, dtype=torch.float64)
    while not ctx.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for rank in ranks:
        for policy in POLICIES:
            for (s, met, ver), (s0, met0, ver0) in zip(rank[policy], rank[None]):
                assert met == met0 and ver == ver0 and all(v == 2 for v in ver.values())
                for tree in ("model", "ema", "mom"):
                    for k, v in s0[tree].items():
                        assert np.array_equal(s[tree][k], v), f"{policy} {tree} {k}"
    for (s, met, _), (s1, met1, _) in zip(ranks[0]["full"], one):
        for k in ("loss", "iou", "dfl", "cls"):
            np.testing.assert_allclose(met[k], met1[k], rtol=1e-5, atol=1e-6)
        for tree in ("model", "ema", "mom"):
            assert s[tree].keys() == s1[tree].keys()
            rtol, atol = (1e-4, 2e-5) if tree == "mom" else (1e-5, 1e-6)
            for k, v in s1[tree].items():
                np.testing.assert_allclose(s[tree][k], v.numpy(), rtol=rtol, atol=atol,
                                           err_msg=f"{tree} {k}")
